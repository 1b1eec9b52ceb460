"""Every integrator, time grid and aggregation choice of the port against the JAX package.

  * sampler: euler, heun, rk4, dpm2m and dpm3m on the karras grid, each integrating the
    test-width denoisers (random weights, shared) from the same x0, to the bar of
    ``test_dpm3m_sampler`` (rtol 1e-5, atol 1e-5); trajectories match in shape and values;
  * aggregation: every ``aggregate_hand`` and ``aggregate_obj`` mode (the object cascade with
    force selection on and off), same candidates: identical selections, fused outputs within
    5e-4 (the aggregation bar), and the ``power`` quaternion mean;
  * ``forward_predict`` with a non-default pair of aggregation modes and the trajectory.

Heat stays positive and every candidate lands inside its heatmap (bboxes wider than the crop):
outside it the heat is exactly +-0 and the order of such ties rests on the sign of a zero
(see ``test_forward_predict_matches_jax``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.diffusion import sampler as jax_sampler
from vpho_tpu.models import aggregation as jagg
from vpho_tpu.models import anchor as janchor
from vpho_tpu.models import mano as jmano
from vpho_tpu.models import vpho as JV
from vpho_tpu.utils import transforms as JT
from vpho_tpu_torch.data import fixtures as tfix
from vpho_tpu_torch.diffusion import sampler as tsampler
from vpho_tpu_torch.models import aggregation as tagg
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.utils import transforms as TT
from vpho_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_model import _random_variables

torch.set_num_threads(1)

CFG = dict(sample_num=3, sampling_steps=5, topk_hand=2, topk_obj=3, patch_size=64)
WIDE = np.array([-100.0, -100.0, 164.0, 164.0], np.float32)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    jctx = JV.make_context(JV.ModelConfig(**CFG))
    tctx = TV.make_context(TV.ModelConfig(**CFG), device="cpu")
    jbatch = jax_make_batch(jctx, jax.random.PRNGKey(8), 2, 64)
    jmodel = JV.VPHONet()
    rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    variables = _random_variables(dict(jax.eval_shape(lambda: jmodel.init(rngs, jbatch, False))))
    tmodel = TV.VPHONet().eval()
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
        batch[k] = np.tile(WIDE, (2, 1))
    return jctx, tctx, jmodel, variables, tmodel, batch


# ---- sampler ------------------------------------------------------------------------------


@pytest.mark.parametrize("method,schedule", [("euler", "uniform"), ("heun", "uniform"),
                                             ("rk4", "uniform"), ("dpm2m", "uniform"),
                                             ("dpm3m", "karras")])
def test_sampler_on_denoisers(setup, method, schedule):
    jctx, tctx, jmodel, variables, tmodel, _ = setup
    rng = np.random.RandomState(3)
    feat_h, feat_o = (rng.randn(2, 1024).astype(np.float32) for _ in range(2))
    S, steps, T0 = CFG["sample_num"], CFG["sampling_steps"], 0.65
    key = jax.random.PRNGKey(5)

    def jax_run(fh, fo):
        sh = JV._score_fn(jmodel, variables, jctx.sde, "hand", fh, S)
        so = JV._score_fn(jmodel, variables, jctx.sde, "obj", fo, S)
        both = lambda x, t: jnp.concatenate([sh(x[:, :96], t), so(x[:, 96:], t)], -1)
        return jax_sampler.ode_sampler(both, key, 2 * S, 105, jctx.sde, T0, steps,
                                       method=method, schedule=schedule)

    ref_traj, ref = jax.jit(jax_run)(feat_h, feat_o)
    x0 = np.asarray(jctx.sde.prior(key, (2 * S, 105), T=T0))
    sh = TV._score_fn(tmodel.denoiser_hand, tctx.sde, _t(feat_h))
    so = TV._score_fn(tmodel.denoiser_obj, tctx.sde, _t(feat_o))
    both = lambda x, t: torch.cat([sh(x[:, :96], t), so(x[:, 96:], t)], -1)
    calls = []
    counted = lambda x, t: calls.append(t) or both(x, t)
    with torch.no_grad():
        traj, got = tsampler.ode_sampler(counted, _t(x0), tctx.sde, T0, steps, method=method,
                                         schedule=schedule, return_trajectory=True)
    assert len(calls) == tsampler.score_evals(method, steps)
    assert np.abs(np.asarray(ref)).max() > 1.0           # the score moved the state
    close(got, ref, rtol=1e-5, atol=1e-5)
    assert traj.shape == ref_traj.shape == (2 * S, steps, 105)
    close(traj, ref_traj, rtol=1e-5, atol=1e-5)
    close(tsampler.time_grid(tctx.sde, T0, steps, schedule),
          jax_sampler.time_grid(jctx.sde, T0, steps, schedule), rtol=1e-6, atol=0)


# ---- aggregation --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agg_inputs(setup):
    jctx, _, _, _, _, batch = setup
    B, S = 2, 6
    rng = np.random.RandomState(6)
    d6 = np.asarray(JT.matrix_to_rotation_6d(JT.axis_angle_to_matrix(
        rng.randn(B, S, 3).astype(np.float32) * 0.5)))
    pose = (rng.randn(B, S, 48) * 0.3).astype(np.float32)
    shape = np.repeat((rng.randn(B, 1, 10) * 0.3).astype(np.float32), S, 1)
    a = dict(
        pose=pose, shape=shape, pose_regression=(rng.randn(B, 48) * 0.3).astype(np.float32),
        root_joint_flip=batch["root_joint_flip"], root_joint=batch["root_joint"],
        cam_intrinsic=batch["cam_intr_crop_flip"], is_right=np.array([True, False]),
        hand_heatmap=(rng.rand(B, 21, 64, 64) + 0.1).astype(np.float32),
        obj_heatmap=(rng.rand(B, 27, 64, 64) + 0.1).astype(np.float32),
        bbox=batch["bbox_hand"], obj_bbox=batch["bbox_obj_rect"], obj_ids=batch["obj_id"],
        pose6d=np.concatenate([d6, (rng.randn(B, S, 3) * 0.03).astype(np.float32)], -1),
        is_grasped=np.array([1.0, 0.0], np.float32),
        force_local=(rng.randn(B, 32, 3) * 0.1).astype(np.float32))
    verts, _ = jmano.hand_verts_meters(jctx.mano, pose[:, 0], shape[:, 0])
    fp, fg = janchor.force_local_to_global(jctx.anchor_tables, a["force_local"],
                                           verts + a["root_joint_flip"][:, None])
    a["force_point"], a["force_global"] = np.asarray(fp), np.asarray(fg)
    return a


HAND_MODES = ["heatmap_cascade", "heatmap_cascade_n_level", "heatmap", "2D_pt_pose",
              "2D_pt_joint", "average_all", "random"]


@pytest.mark.parametrize("mode,impl", [(m, "eigh") for m in HAND_MODES]
                         + [("heatmap_cascade", "power"), ("average_all", "power")])
def test_aggregate_hand(setup, agg_inputs, mode, impl, monkeypatch):
    jctx, tctx = setup[:2]
    a = agg_inputs
    names = ("pose", "shape", "pose_regression", "root_joint_flip", "cam_intrinsic",
             "hand_heatmap", "bbox")

    def call(lib, mano, arrays):
        kw = dict(zip(names, arrays))
        kw["root_joint"], kw["heatmap"] = kw.pop("root_joint_flip"), kw.pop("hand_heatmap")
        return lib.aggregate_hand(mode, mano, k=CFG["topk_hand"], **kw)

    monkeypatch.setattr(JT, "QUAT_MEAN_IMPL", impl)     # read when the jit traces
    monkeypatch.setattr(TT, "QUAT_MEAN_IMPL", impl)
    ref = jax.jit(lambda *x: call(jagg, jctx.mano, x))(*[a[n] for n in names])
    got = call(tagg, tctx.mano, [_t(a[n]) for n in names])
    assert set(ref) == set(got)
    for k in ref:
        if k == "middle_data":
            for lr, lg in zip(ref[k], got[k]):
                np.testing.assert_array_equal(_np(lg.topk), np.asarray(lr.topk))
        elif k == "topk":
            np.testing.assert_array_equal(_np(got[k]), np.asarray(ref[k]))
        else:
            close(got[k], ref[k], rtol=0, atol=5e-4)


OBJ_MODES = [("heatmap_cascade", True), ("heatmap_cascade", False), ("heatmap", False),
             ("2D_pt_pose", False), ("average_all", False), ("random", False)]


@pytest.mark.parametrize("mode,force", OBJ_MODES)
def test_aggregate_obj(setup, agg_inputs, mode, force):
    jctx, tctx = setup[:2]
    a = agg_inputs
    names = ("pose6d", "root_joint", "obj_ids", "is_right", "cam_intrinsic", "obj_heatmap",
             "obj_bbox", "force_point", "force_global", "is_grasped")

    def call(lib, registry, arrays):
        kw = dict(zip(names, arrays))
        kw["heatmap"], kw["bbox"] = kw.pop("obj_heatmap"), kw.pop("obj_bbox")
        return lib.aggregate_obj(mode, registry, k=CFG["topk_obj"], force_selection=force, **kw)

    ref = jax.jit(lambda *x: call(jagg, jctx.registry, x))(*[a[n] for n in names])
    got = call(tagg, tctx.registry, [_t(a[n]) for n in names])
    assert set(ref) == set(got)
    for k in ref:
        close(got[k], ref[k], rtol=0, atol=5e-4)


# ---- forward_predict with a non-default pair ------------------------------------------------


def test_forward_predict_standalone_modes(setup):
    """``--aggregation_mode_hand heatmap --aggregation_mode_obj heatmap_cascade`` (force
    selection on), with the trajectory, f32, same weights and x0: as
    ``test_forward_predict_matches_jax`` bars it."""
    cfg = dict(CFG, aggregation_mode_hand="heatmap")
    jctx = setup[0]._replace(cfg=JV.ModelConfig(**cfg))
    _, tctx, jmodel, variables, tmodel, batch = setup
    tctx = tctx._replace(cfg=TV.ModelConfig(**cfg))
    key = jax.random.PRNGKey(9)
    x0 = np.asarray(jctx.sde.prior(key, (2 * CFG["sample_num"], 105), T=jctx.cfg.sample_T0))
    ref = jax.jit(lambda v, b, r: JV.forward_predict(jmodel, v, jctx, b, r,
                                                     return_trajectory=True))(variables, batch, key)
    got = TV.forward_predict(tmodel, tctx, tfix.to_device(batch, "cpu"), x0=_t(x0),
                             return_trajectory=True)
    assert set(ref) == set(got)
    for k in ("diff_final_hand_mano", "diff_final_obj_6d", "diff_inprocess_hand_6d",
              "diff_inprocess_obj_6d"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=0, atol=1e-3, err_msg=k)
    for k in ("agg_obj_6d", "agg_hand_mano", "agg_hand_vert", "agg_hand_joint"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=0, atol=5e-4, err_msg=k)
