"""The port's network modules and the whole f32 ``forward_predict`` against the JAX package,
with the same weights (carried across by ``state_dict_from_jax``) and the same inputs.

Size: tests/test_model.py's (patch 64, bs 2, S 4, 5 dpm3m steps, topk 3/2).  The weights are
numpy draws in the JAX variables' shapes (no zero-initialised layer), so the ODE integrates a
non-zero score and every carried tensor reaches the outputs.  Bars: denoiser score rtol 2e-5; encoder rtol 1e-4; FPN rtol
1e-3; whole predict path as stated in ``test_forward_predict_matches_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.models import vpho as JV
from vpho_tpu.utils.torch_import import export_vpho_state_dict
from vpho_tpu_torch.data import fixtures as tfix
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.ops import bank_mlp as K1
from vpho_tpu_torch.utils.weights import state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(sample_num=4, sampling_steps=5, topk_hand=3, topk_obj=2, patch_size=64)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def rel_err(got, ref):
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _random_variables(shapes, seed=0):
    """Flax variables of the given shapes filled from a numpy seed: kernels at 1/sqrt(fan_in),
    small non-zero biases, BN statistics away from (0, 1), so every mapped tensor matters."""
    rng = np.random.RandomState(seed)

    def fill(path, sds):
        coll, name, shape = path[0].key, path[-1].key, sds.shape
        if coll == "batch_stats":
            v = rng.randn(*shape) * 0.1 if name == "mean" else rng.uniform(0.5, 1.5, shape)
        elif coll == "buffers":
            v = rng.randn(*shape) * 30.0
        elif name == "scale":
            v = 1.0 + rng.randn(*shape) * 0.1
        elif name.startswith("kernel"):
            if name.startswith("kernel") and len(shape) == 3 and path[-2].key == "bank":
                fan_in = shape[1]
            elif path[-2].key == "out":
                fan_in = shape[0] * shape[1]
            else:
                fan_in = int(np.prod(shape[:-1])) if len(shape) != 3 else shape[0]
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif path[1].key.startswith("head_hm") and path[2].key == "Conv_2":
            v = np.ones(shape)        # positive heatmaps, as a trained head gives (see below)
        else:
            v = rng.randn(*shape) * 0.02
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    jctx = JV.make_context(JV.ModelConfig(**CFG))
    jbatch = jax_make_batch(jctx, jax.random.PRNGKey(8), 2, 64)
    jmodel = JV.VPHONet()
    rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    variables = _random_variables(dict(jax.eval_shape(lambda: jmodel.init(rngs, jbatch, False))))
    tmodel = TV.VPHONet().eval()
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch_np = {k: np.asarray(v) for k, v in jbatch.items()}
    return jmodel, variables, tmodel, batch_np, jctx


def test_state_dict_matches_export(setup):
    _, variables, tmodel, _, _ = setup
    ref = export_vpho_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert set(got) == set(ref) == set(tmodel.state_dict())
    assert len(got) == 982
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_denoiser_scores(setup):
    jmodel, variables, tmodel, _, _ = setup
    rng = np.random.RandomState(1)
    feat = rng.randn(3, 1024).astype(np.float32)
    for head, dim in (("hand", 96), ("obj", 9)):
        x = rng.randn(3, dim).astype(np.float32)
        t = rng.rand(3, 1).astype(np.float32)
        std = (rng.rand(3, 1) + 0.5).astype(np.float32)
        ref = jmodel.apply(variables, feat, x, t, std, method=getattr(JV.VPHONet, f"denoise_{head}"))
        den = getattr(tmodel, f"denoiser_{head}")
        got = den(_t(feat), _t(x), _t(t), _t(std))
        assert rel_err(got, ref) < 2e-5, head
        # ODE fast path: per-sample projection broadcast over S = 4 rows, shared t
        xs = rng.randn(12, dim).astype(np.float32)
        t1 = np.full((1, 1), 0.3, np.float32)
        proj = jmodel.apply(variables, feat, method=getattr(JV.VPHONet, f"precompute_{head}_feat"))
        ref = jmodel.apply(variables, proj, xs, t1, 0.7,
                           method=getattr(JV.VPHONet, f"denoise_{head}_from_proj"))
        got = den.score_from_proj(den.precompute_feat(_t(feat)), _t(xs), _t(t1), 0.7)
        assert rel_err(got, ref) < 2e-5, head


def test_bf16_hand_fast_path_matches_jax(setup):
    """K1's call site: the bf16 hand head's ODE fast path (shared t, per-sample projection,
    operands prepared once by ``prepare_fused``), which on the CPU runs K1's plain version,
    against JAX's ``denoise_hand_from_proj`` under the bf16 policy with the same weights.
    Bar: 0.03 of the score's scale, since bf16 rounds at other points in XLA's einsum path
    (there the t, pose and conditioning terms are each rounded to bf16 before they are added;
    here they are added in f32 and h is rounded once, after the relu)."""
    _, variables, tmodel, _, _ = setup
    jmodel = JV.VPHONet(compute_dtype=jnp.bfloat16)
    port = TV.VPHONet(compute_dtype=torch.bfloat16).eval()
    port.load_state_dict(tmodel.state_dict(), strict=True)
    den = port.denoiser_hand
    assert den.head.runs_k1
    rng = np.random.RandomState(3)
    B, S = 2, 5
    feat = rng.randn(B, 1024).astype(np.float32)
    xs = rng.randn(B * S, 96).astype(np.float32)
    t1 = np.full((1, 1), 0.4, np.float32)
    proj = jmodel.apply(variables, feat, method=JV.VPHONet.precompute_hand_feat)
    ref = np.asarray(jmodel.apply(variables, proj, xs, t1, 0.7,
                                  method=JV.VPHONet.denoise_hand_from_proj), np.float32)
    with torch.no_grad():
        feat_proj = den.precompute_feat(_t(feat))
        fused = den.head.prepare_fused(feat_proj)
        before = K1.launches
        got = den.score_from_proj(feat_proj, _t(xs), _t(t1), 0.7, fused)
        assert K1.launches == before                  # the CPU takes the plain version
        # prepared once or made at the call: the same operands, the same score
        torch.testing.assert_close(den.score_from_proj(feat_proj, _t(xs), _t(t1), 0.7), got,
                                   rtol=0, atol=0)
    assert got.shape == ref.shape == (B * S, 96)
    assert np.abs(_np(got) - ref).max() <= 0.03 * np.abs(ref).max()


def test_encoder_heatmap_head_fpn(setup):
    jmodel, variables, tmodel, batch, _ = setup
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 32, 256 + 21).astype(np.float32)
    ref, ref_ls = jmodel.apply(variables, x, method=lambda m, x: m.encoder_hand(x))
    got, got_ls = tmodel.encoder_hand(_t(x).permute(0, 3, 1, 2))
    assert rel_err(got, ref) < 1e-4
    assert rel_err(got_ls[1], np.asarray(ref_ls[1]).transpose(0, 3, 1, 2)) < 1e-4
    f = rng.randn(2, 32, 32, 256).astype(np.float32)
    ref = jmodel.apply(variables, f, method=lambda m, x: m.head_hm_hand(x))
    got = tmodel.head_hm_hand(_t(f).permute(0, 3, 1, 2))
    assert rel_err(got, np.asarray(ref).transpose(0, 3, 1, 2)) < 1e-4
    ref_h, ref_o = jax.jit(lambda v, x: jmodel.apply(v, x, method=lambda m, x: m.feature_extractor(x)))(
        variables, batch["rgb"])
    got_h, got_o = tmodel.feature_extractor(_t(batch["rgb"]).permute(0, 3, 1, 2))
    assert rel_err(got_h, np.asarray(ref_h).transpose(0, 3, 1, 2)) < 1e-3
    assert rel_err(got_o, np.asarray(ref_o).transpose(0, 3, 1, 2)) < 1e-3


def test_forward_predict_matches_jax(setup):
    """Whole predict path, f32, same weights and same ODE start state.  Trunk outputs within
    rtol 1e-3 of their scale (the FPN bar), the ODE's final hypotheses within 1e-3, and the
    aggregated hand and object within 5e-4 (the aggregation bar) of the JAX result.

    Two choices keep the comparison well-posed.  The heatmap heads' final bias is 1, so heat
    values are positive as a trained head's are; mixed-sign heat makes the cascade's
    normalized fusion weights divide by a sum near zero.  And the bboxes are widened past the
    crop so that every candidate's joints and keypoints land inside its heatmap: outside it
    the bicubic heat is exactly +-0, and the sign of such a zero, which orders
    ``jax.lax.top_k``'s ties, depends on each library's summation order."""
    jmodel, variables, tmodel, batch, jctx = setup
    batch = dict(batch)
    for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
        batch[k] = np.tile(np.array([-100.0, -100.0, 164.0, 164.0], np.float32), (2, 1))
    tctx = TV.make_context(TV.ModelConfig(**CFG), device="cpu")
    key = jax.random.PRNGKey(9)
    B, S = 2, CFG["sample_num"]
    x0 = np.asarray(jctx.sde.prior(key, (B * S, 105), T=jctx.cfg.sample_T0))
    ref = jax.jit(lambda v, b, r: JV.forward_predict(jmodel, v, jctx, b, r))(variables, batch, key)
    got = TV.forward_predict(tmodel, tctx, tfix.to_device(batch, "cpu"), x0=_t(x0))
    assert set(ref) == set(got)
    for k in ("hand_heatmap", "obj_heatmap", "force_local", "reg_hand_vert"):
        assert rel_err(got[k], ref[k]) < 1e-3, k
    for k in ("diff_final_hand_mano", "diff_final_obj_6d", "diff_final_hand_vert"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=0, atol=1e-3, err_msg=k)
    for k in ("agg_obj_6d", "agg_hand_mano", "agg_hand_vert", "agg_hand_joint"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=0, atol=5e-4, err_msg=k)


def test_port_fixture_batch_runs_predict():
    cfg = TV.ModelConfig(**CFG, compute_dtype="bfloat16")
    ctx = TV.make_context(cfg, device="cpu")
    model = TV.build_model(cfg, seed=0, device="cpu")
    batch = tfix.make_batch(ctx, seed=3, batch_size=2, patch_size=64)
    out = TV.forward_predict(model, ctx, batch, generator=torch.Generator().manual_seed(0))
    shapes = {"agg_obj_6d": (2, 9), "agg_hand_mano": (2, 58), "agg_hand_vert": (2, 778, 3),
              "diff_final_hand_mano": (2, 4, 58), "hand_heatmap": (2, 21, 64, 64)}
    for k, shape in shapes.items():
        assert tuple(out[k].shape) == shape, k
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_head_object_regress_matches_jax():
    """``HeadObjectRegress`` and ``object_regress_losses`` (which no path calls) against the
    JAX package's, on ``tests/test_aux.py``'s case with random weights and inputs: rtol 1e-5."""
    from vpho_tpu.models.heads import HeadObjectRegress as JHead, \
        object_regress_losses as jax_losses
    from vpho_tpu_torch.models.heads import HeadObjectRegress, object_regress_losses
    from vpho_tpu_torch.utils.weights import object_regress_state_dict

    rng = np.random.RandomState(0)
    x = rng.randn(2, 1024).astype(np.float32)
    variables = JHead().init(jax.random.PRNGKey(0), jnp.ones((2, 1024)))
    params = jax.tree.map(lambda v: np.asarray(v) + 0.01 * rng.randn(*v.shape).astype(np.float32),
                          variables["params"])
    ref = np.asarray(JHead().apply({"params": params}, x))
    head = HeadObjectRegress()
    head.load_state_dict(object_regress_state_dict(params), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert got.shape == (2, 9)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-6)
    gts = [rng.randn(*s).astype(np.float32) for s in ((2, 2048, 3), (2, 27, 3), (2, 9),
                                                         (2, 2048, 3), (2, 27, 3))]
    want = jax_losses(ref, *gts)
    have = object_regress_losses(got, *map(_t, gts))
    assert set(have) == set(want) == {"obj_reg_vert_loss", "obj_reg_kpt_loss",
                                      "obj_reg_rot6d_loss", "obj_reg_trans_loss"}
    for k in want:
        np.testing.assert_allclose(float(have[k]), float(want[k]), rtol=1e-5, err_msg=k)
