"""The port's compiled steps (``engine/graphs.py``, ``make_predict_step``,
``make_candidate_step``, the force loop on graphs) and the quaternion mean's eigen-solver, on
the CPU, against the JAX package.

On the CPU a step calls its function eagerly (a CPU tensor has no graph), so these tests hold
the very functions that the card captures:
  * ``make_predict_step`` / ``make_candidate_step`` against JAX's jitted ``make_predict_step`` /
    ``make_candidate_step``, same weights (``state_dict_from_jax``) and ODE start state, at
    ``tests/test_torch_port_model.py``'s size and bars: trunk outputs rtol 1e-3 of their
    scale, the ODE's hypotheses atol 1e-3, the aggregated hand and object atol 5e-4;
  * ``dominant_eigvec_4x4_jacobi`` against ``jnp.linalg.eigh`` (float32) on random PSD
    matrices and on near-degenerate ones (hypothesis);
  * ``optimize_forces`` (device-side bias corrections) against JAX's across the phase
    boundary, within ``tests/test_torch_port_force.py``'s bars, and bit for bit equal to the
    eager loop it replaced (the trainer's ``Optimizer`` with host bias corrections);
  * the steps run no operation that makes the host wait on a card;
  * ``CapturedStep``'s signature cache and static buffers, with a stand-in for the CUDA graph.
"""
import collections
import dataclasses
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import force_optim as JF
from vpho_tpu.engine import trainer as JT
from vpho_tpu.models import anchor as JA
from vpho_tpu.models import vpho as JV
from vpho_tpu.models.mano import hand_verts_meters, synthetic_mano as jax_synthetic_mano
from vpho_tpu_torch.data import fixtures as tfix
from vpho_tpu_torch.engine import force_optim as TF
from vpho_tpu_torch.engine import graphs as G
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.models import anchor as TA
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.models.heads import friction_anchor_dirs
from vpho_tpu_torch.models.mano import synthetic_mano
from vpho_tpu_torch.utils import transforms as TTR
from vpho_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_model import CFG, _random_variables, _t, rel_err

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """JAX model, variables and context; the port's model with the same weights; a batch whose
    bboxes lie past the crop (``test_forward_predict_matches_jax`` says why); one x0."""
    jctx = JV.make_context(JV.ModelConfig(**CFG))
    jbatch = jax_make_batch(jctx, jax.random.PRNGKey(8), 2, 64)
    jmodel = JV.VPHONet()
    rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    variables = _random_variables(dict(jax.eval_shape(lambda: jmodel.init(rngs, jbatch, False))))
    tmodel = TV.VPHONet().eval()
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
        batch[k] = np.tile(np.array([-100.0, -100.0, 164.0, 164.0], np.float32), (2, 1))
    state = JT.TrainState(step=0, apply_fn=jmodel.apply, params=variables["params"], tx=None,
                          opt_state=None, batch_stats=variables["batch_stats"],
                          buffers=variables["buffers"])
    key = jax.random.PRNGKey(9)
    x0 = np.asarray(jctx.sde.prior(key, (2 * CFG["sample_num"], 105), T=jctx.cfg.sample_T0))
    tctx = TV.make_context(TV.ModelConfig(**CFG), device="cpu")
    return jmodel, jctx, state, tmodel, tctx, batch, key, x0


def test_predict_step_matches_jax(setup):
    jmodel, jctx, state, tmodel, tctx, batch, key, x0 = setup
    ref = JT.make_predict_step(jmodel, jctx)(state, batch, key)
    step = TT.make_predict_step(tmodel, tctx)
    got = step(tfix.to_device(batch, "cpu"), _t(x0))
    assert set(ref) == set(got)
    for k in ("hand_heatmap", "obj_heatmap", "force_local", "reg_hand_vert"):
        assert rel_err(got[k], ref[k]) < 1e-3, k
    for k in ("diff_final_hand_mano", "diff_final_obj_6d", "diff_final_hand_vert"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-3,
                                   err_msg=k)
    for k in ("agg_obj_6d", "agg_hand_mano", "agg_hand_vert", "agg_hand_joint"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=5e-4,
                                   err_msg=k)
    assert not step.graphs                   # the CPU calls the function: nothing captured


def test_candidate_step_matches_jax(setup):
    jmodel, jctx, state, tmodel, tctx, batch, key, x0 = setup
    ref = JT.make_candidate_step(jmodel, jctx)(state, batch, key)
    got = TT.make_candidate_step(tmodel, tctx)(tfix.to_device(batch, "cpu"), _t(x0))
    assert set(got) == set(ref) and not any(k.startswith("agg_") for k in got)
    for k in ("hand_heatmap", "obj_heatmap", "force_local", "reg_hand_vert"):
        assert rel_err(got[k], ref[k]) < 1e-3, k
    for k in ("diff_final_hand_mano", "diff_final_obj_6d", "diff_final_hand_vert"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-3,
                                   err_msg=k)


# The eigen-solver.  Bar: up to sign, |v - v_jax| <= 64 eps32 / gap + 1e-6 per entry, gap the
# relative distance of the top two eigenvalues (float32 eigh's eigenvector error is ~eps/gap:
# on 4000 random matrices JAX's is at most 6.5 eps / gap from float64's, the port's 0.5 eps);
# and for every matrix, near-degenerate ones included, the port's Rayleigh quotient reaches
# JAX's largest eigenvalue within 8 eps32 of the matrix's scale, its residual |Av - v^T A v v|
# within 16 eps32 of it.
EPS32 = float(np.finfo(np.float32).eps)


def _eig_check(A: np.ndarray):
    got = TTR.dominant_eigvec_4x4_jacobi(torch.from_numpy(A)).numpy().astype(np.float64)
    w, v = jnp.linalg.eigh(jnp.asarray(A))
    w, ref = np.asarray(w, np.float64), np.asarray(v, np.float64)[..., -1]
    A64 = A.astype(np.float64)
    scale = np.abs(w).max(-1)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=4 * EPS32)
    rayleigh = np.einsum("...i,...ij,...j->...", got, A64, got)
    assert np.all(rayleigh >= w[..., -1] - 8 * EPS32 * scale)
    resid = np.linalg.norm(np.einsum("...ij,...j->...i", A64, got) - rayleigh[..., None] * got,
                           axis=-1)
    assert np.all(resid <= 16 * EPS32 * scale)
    gap = (w[..., -1] - w[..., -2]) / scale
    sign = np.sign((got * ref).sum(-1, keepdims=True))
    err = np.abs(got * sign - ref).max(-1)
    assert np.all(err <= 64 * EPS32 / np.maximum(gap, 1e-30) + 1e-6)


def test_jacobi_eigvec_matches_jax_eigh_on_random_psd():
    rng = np.random.RandomState(0)
    X = rng.randn(4000, 4, 4).astype(np.float32)
    _eig_check((np.einsum("nij,nkj->nik", X, X) / 4).astype(np.float32))
    # the quaternion mean's own matrices: weighted outer products of unit quaternions
    q = rng.randn(500, 30, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    wq = rng.rand(500, 30)
    A = np.einsum("nk,nki,nkj->nij", wq / wq.sum(1, keepdims=True), q, q)
    _eig_check(A.astype(np.float32))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), top=st.floats(0.1, 10.0),
       log_gap=st.floats(-9.0, -1.0), mult=st.integers(1, 3))
def test_jacobi_eigvec_on_near_degenerate_psd(seed, top, log_gap, mult):
    """``mult`` eigenvalues within 10^log_gap (relative) of the top one."""
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.randn(4, 4))[0]
    lam = np.sort(rng.uniform(0.0, top, 4))
    lam[3] = top
    for i in range(1, mult + 1):
        lam[3 - i] = top * (1.0 - 10.0 ** log_gap * rng.rand())
    A = (Q * lam) @ Q.T
    _eig_check(((A + A.T) / 2).astype(np.float32)[None])


# the steps, scanned for the operations that make the host wait on a card (or, for an index
# list, copy it there): none may run once the step's constants exist
_WAITS = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique2",
          "repeat_interleave", "_linalg_check_errors", "linalg_eigh", "_linalg_eigh",
          "linalg_svd", "_linalg_svd", "linalg_inv", "lift_fresh", "equal", "is_nonzero",
          "bincount", "histc")


class _WaitScan(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.hits = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _WAITS:
            port = [f for f in traceback.extract_stack() if "vpho_tpu_torch" in f.filename]
            self.hits[(name, f"{port[-1].filename}:{port[-1].lineno}" if port else "?")] += 1
        return func(*args, **(kwargs or {}))


def _scan(fn):
    fn()                                  # the first call makes the constant index tensors
    with _WaitScan() as scan:
        fn()
    return dict(scan.hits)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_steps_make_no_host_wait(dtype):
    cfg = TV.ModelConfig(**CFG, compute_dtype=dtype)
    ctx = TV.make_context(cfg, device="cpu")
    model = TV.build_model(cfg, seed=0, device="cpu")
    batch = tfix.make_batch(ctx, seed=3, batch_size=2, patch_size=64)
    x0 = TV.draw_x0(ctx, 2, torch.Generator().manual_seed(0))
    for make in (TT.make_predict_step, TT.make_candidate_step):
        step = make(model, ctx)
        assert _scan(lambda: step(batch, x0)) == {}, make.__name__
    # every other aggregation choice and integrator (the eval entry point captures them too)
    pd, out = TV.forward_candidates(model, ctx, batch, x0=x0)
    pairs = [(h, "heatmap") for h in ("heatmap", "2D_pt_pose", "2D_pt_joint", "average_all",
                                      "random")]
    pairs += [("heatmap", o) for o in ("heatmap_cascade", "2D_pt_pose", "average_all")]
    for mh, mo in pairs:
        actx = ctx._replace(cfg=dataclasses.replace(cfg, aggregation_mode_hand=mh,
                                                    aggregation_mode_obj=mo))
        assert _scan(lambda: TV.aggregate(actx, batch, dict(pd), out)) == {}, (mh, mo)
    for method in ("euler", "heun", "rk4", "dpm2m"):
        mctx = ctx._replace(cfg=dataclasses.replace(cfg, ode_method=method))
        assert _scan(lambda: TV.forward_candidates(model, mctx, batch, x0=x0)) == {}, \
            method


def _train_step_scan(tmp_path):
    """The train step's device work (graph A: forward, backward, MultiSteps' accumulation; graph
    B: the clipped AdamW update), on masks and draws given as its inputs."""
    from vpho_tpu_torch.configs.config import get_config

    cfg = get_config(["--mode", "train", "--batch_size", "2", "--patch_size", "64",
                      "--repeat_num", "2", "--gradient_clip", "1e-3",
                      "--gradient_accumulation_steps", "2", "--output_dir", str(tmp_path)])
    trainer = TT.Trainer(cfg, device="cpu")
    trainer.init_state(1)
    step, opt = TT.make_train_step(trainer.model, trainer.ctx, trainer.optimizer), trainer.optimizer
    batch = tfix.make_batch(trainer.ctx, seed=0, batch_size=2, patch_size=64)
    gen = torch.Generator().manual_seed(0)
    opt.advance()
    step._device_step(batch, None, None, gen)             # its warm-up: the masks' shapes
    masks = step.draw_masks([tuple(m.shape) for m in step._drawn], gen)
    draws = step.draw_score(2, gen)
    opt.advance()

    def graphs():
        step._device_step(batch, masks, draws)
        opt.apply()
    return graphs


def _metric_steps_scan(tmp_path):
    from vpho_tpu_torch.engine import tester as TE
    from vpho_tpu_torch.models.vpho import make_context

    ctx = make_context(TV.ModelConfig(), device="cpu")
    rng = np.random.RandomState(0)
    f = lambda *shape: torch.from_numpy((rng.randn(*shape) * 0.05 + [0, 0, 0.6]).astype(np.float32))
    rt = torch.cat([TTR.axis_angle_to_matrix(torch.from_numpy(rng.randn(4, 3).astype(np.float32))),
                    f(4, 3)[..., None]], -1)
    K = torch.tensor([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]]).repeat(4, 1, 1)
    ids = torch.tensor([0, 5, 11, 20], dtype=torch.int32)
    hand_args = (f(4, 21, 3), f(4, 21, 3), f(4, 778, 3), f(4, 778, 3))
    return lambda: (TE.HAND_METRICS(*hand_args),
                    TE.object_metrics_step(ctx.registry)(rt, rt + 0.01, ids, K))


def _preprocess_scan(tmp_path):
    from vpho_tpu_torch.configs.config import Config
    from vpho_tpu_torch.data import dexycb as D
    from vpho_tpu_torch.data.device_pipeline import make_device_preprocess
    from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb

    root = build_mini_dexycb(str(tmp_path / "dex"), n=2, seed=3, sides=["right", "left"])
    runs = []
    for is_train in (False, True):
        cfg = Config(data_dir=root, patch_size=64, device_preprocess=True)
        ds = D.DexYCBForceDataset(cfg, root, is_train=is_train)
        raw = {k: torch.as_tensor(v) for k, v in D.collate([ds[0], ds[1]]).items()}
        pre = make_device_preprocess(cfg, is_train)
        gen = torch.Generator().manual_seed(0)
        runs.append(lambda pre=pre, raw=raw, gen=gen: pre(raw, generator=gen))
    return lambda: [run() for run in runs]


@pytest.mark.parametrize("make", [_train_step_scan, _metric_steps_scan, _preprocess_scan],
                         ids=["train", "metrics", "preprocess"])
def test_train_metric_and_preprocess_steps_make_no_host_wait(make, tmp_path):
    """``test_steps_make_no_host_wait``'s scan over the other captured steps: the train step
    (with the clip and accumulation), both metric steps, and the eval and train preprocess."""
    assert _scan(make(tmp_path)) == {}


@pytest.fixture(scope="module")
def force_case():
    """tests/test_torch_port_force.py's case: B = 3 synthetic-MANO hands, some anchors under
    the contact threshold, unit gravity, a CoM near the hand."""
    jt = JA.load_anchor_tables(jax_synthetic_mano())
    tt = TA.load_anchor_tables(synthetic_mano(device="cpu"), device="cpu")
    rng = np.random.RandomState(0)
    pose = (rng.randn(3, 48) * 0.2).astype(np.float32)
    vert = np.asarray(hand_verts_meters(jax_synthetic_mano(), jnp.asarray(pose),
                                        jnp.zeros((3, 10)))[0]).astype(np.float32)
    g = rng.randn(3, 1, 3) + [0.0, 2.0, 0.0]
    inputs = [(np.abs(rng.randn(3, 32)) * 0.5).astype(np.float32), vert,
              (g / np.linalg.norm(g, axis=-1, keepdims=True)).astype(np.float32),
              (vert.mean(1, keepdims=True) + rng.randn(3, 1, 3) * 0.02).astype(np.float32)]
    return jt, tt, inputs


def _eager_loop(force_contact, vert3d, gravity, com, tables, iters_phase1, iters_total):
    """The loop ``optimize_forces`` ran before it went on graphs: the trainer's ``Optimizer``
    (bias corrections as host floats), the phase a Python ``if``.  Returns (scale, weight)."""
    bs = force_contact.shape[0]
    contact_mask = (force_contact > 0.1).float()
    scale = torch.full((bs, TF.N_ANCHOR), 0.05, requires_grad=True)
    weight = torch.zeros((bs, TF.N_ANCHOR, 8), requires_grad=True)
    opt = TT.Optimizer({"scale": scale, "weight": weight}, "adamw", lambda step: TF.LR)
    force_point, frame = TA.anchor_points_and_frames(tables, vert3d)
    dirs = friction_anchor_dirs(8, 0.8, "cpu")
    fcn = TF._unit_rows(force_contact)
    for i in range(iters_total):
        s, _, force_global = TF._forces(scale, weight, contact_mask, frame, dirs)
        if i < iters_phase1:
            (g_weight,) = torch.autograd.grad(TF._gravity_loss(force_global, gravity), [weight])
            grads = [torch.zeros_like(scale), g_weight]
        else:
            fl, ml, dl = TF._balance_losses(s, force_global, force_point, fcn, contact_mask,
                                            gravity, com)
            grads = list(torch.autograd.grad(fl + ml + dl, [scale, weight]))
        opt.step(grads)
    return scale.detach(), weight.detach()


def test_optimize_forces_on_device_counters_matches_jax_and_the_eager_loop(force_case):
    """The real phase boundary, 300 gravity iterations, then 40 balance iterations (the
    balance length of test_torch_port_force.py's first case): within that file's bars of JAX
    (forces rtol 1e-4 / atol 1e-5, losses rtol 1e-4), and the decision variables equal to the
    eager loop's bit for bit; a second batch through the same cached loop equals a fresh one.
    The balance phase amplifies the two packages' float32 rounding differences, and not
    evenly: 250 + 40 iterations use 29x the force bar, 10 + 100 7x, and the full 300 + 2700
    leave the forces ~1% apart (ROADMAP §3), the eager loop's as the graphs'."""
    jt, tt, inputs = force_case
    p1, total = 300, 340
    ref = JF.optimize_forces(*map(jnp.asarray, inputs), jt, iters_phase1=p1, iters_total=total)
    targs = [torch.from_numpy(a) for a in inputs]
    got = TF.optimize_forces(*targs, tt, iters_phase1=p1, iters_total=total)
    for k in ("force_local", "force_point", "force_global"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k, v in got["losses"].items():
        np.testing.assert_allclose(v.item(), float(ref["losses"][k]), rtol=1e-4, err_msg=k)
    loop = TF._LOOPS[(3, torch.device("cpu"), total)]
    scale, weight = _eager_loop(*targs, tt, p1, total)
    assert torch.equal(loop.scale.detach(), scale) and torch.equal(loop.weight.detach(), weight)
    assert int(loop.opt.step_t) == total
    # another batch of the same size reuses the loop, reset to step 1
    moved = [targs[0].flip(0), targs[1], targs[2], targs[3]]
    again = TF.optimize_forces(*moved, tt, iters_phase1=p1, iters_total=total)
    TF._LOOPS.clear()
    fresh = TF.optimize_forces(*moved, tt, iters_phase1=p1, iters_total=total)
    for k in ("force_local", "force_global"):
        assert torch.equal(again[k], fresh[k]), k


class _ReplayOnCPU:
    """Stands in for ``graphs.Graph`` on the CPU: "capture" runs the function once, "replay"
    runs it again on the same (static) tensors, into the same output tensors."""

    captures = 0
    marks = {}                              # a CPU "capture" records no stage marks

    def __init__(self, fn, device, name, warm=True, signature="", marked=False):
        type(self).captures += 1
        self.fn, self.out = fn, fn()

    def replay(self):
        for mine, fresh in zip(torch.utils._pytree.tree_leaves(self.out),
                               torch.utils._pytree.tree_leaves(self.fn())):
            mine.copy_(fresh)


def test_captured_step_keys_by_signature(monkeypatch):
    """One entry per signature: a second batch of the same shapes replays the first entry from
    its static buffers, a batch of another size captures a second, and the outputs a caller
    holds are its own (a later call does not overwrite them)."""
    monkeypatch.setattr(G, "Graph", _ReplayOnCPU)
    monkeypatch.setattr(G.CapturedStep, "_device", staticmethod(lambda leaves: torch.device("cuda")))
    _ReplayOnCPU.captures = 0
    fn = lambda batch, x: {"y": batch["a"] * 2.0 + x, "z": batch["b"].sum(-1)}
    step = G.CapturedStep(fn, "test_step")
    rng = np.random.RandomState(0)
    make = lambda n: ({"a": torch.from_numpy(rng.randn(n, 3).astype(np.float32)),
                       "b": torch.from_numpy(rng.randn(n, 4).astype(np.float32))},
                      torch.from_numpy(rng.randn(n, 3).astype(np.float32)))
    first, second, short = make(4), make(4), make(3)
    out1 = step(*first)
    out2 = step(*second)
    assert len(step.graphs) == 1 and _ReplayOnCPU.captures == 1
    for out, args in ((out1, first), (out2, second)):
        for k, v in fn(*args).items():
            assert torch.equal(out[k], v), k
    out3 = step(*short)
    assert len(step.graphs) == 2 and _ReplayOnCPU.captures == 2
    assert torch.equal(out3["y"], fn(*short)["y"])
    assert torch.equal(out1["y"], fn(*first)["y"])        # not overwritten by later calls
    step(*make(3))
    assert len(step.graphs) == 2
    # a non-tensor argument is part of the signature (baked into the graph)
    step2 = G.CapturedStep(lambda x, s: x * s, "scaled")
    step2(first[1], 2.0)
    step2(first[1], 3.0)
    assert len(step2.graphs) == 2
