"""The port's engine pieces against the JAX package on seeded numpy inputs: the config
surface, the transforms the engine adds, the heatmap fixture, the metrics and testers, the
prediction-pkl re-scoring, the profiling helpers and the ``--pretrain`` pickle.

Bars: transforms rtol 1e-5; metrics rtol 1e-5 with rate columns equal; testers' reports
identical.  One deliberate difference: the JAX package projects REP with every camera of the
batch (an (N, N) array, ``vpho_tpu/engine/metrics.py:153-155``), the port with each sample's
own camera, so REP is compared with JAX's diagonal.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.configs import config as jconfig
from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import metrics as JM
from vpho_tpu.engine import tester as JTE
from vpho_tpu.engine import trainer as JTR
from vpho_tpu.models import heads as jheads
from vpho_tpu.models import vpho as JV
from vpho_tpu.ops import heatmap as jheatmap
from vpho_tpu.utils import transforms as JT
from vpho_tpu_torch.configs import config as tconfig
from vpho_tpu_torch.data import fixtures as tfix
from vpho_tpu_torch.data.prefetch import DeviceStager, prefetch
from vpho_tpu_torch.engine import metrics as TM
from vpho_tpu_torch.engine import profiling as TP
from vpho_tpu_torch.engine import tester as TTE
from vpho_tpu_torch.models import heads as theads
from vpho_tpu_torch.models import vpho as TV
from vpho_tpu_torch.ops import heatmap as theatmap
from vpho_tpu_torch.utils import transforms as TT
from vpho_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_cuda import metric_inputs as _metric_inputs, rts

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def contexts():
    cfg = dict(sample_num=2, topk_hand=1, topk_obj=1)
    return JV.make_context(JV.ModelConfig(**cfg)), TV.make_context(TV.ModelConfig(**cfg),
                                                                   device="cpu")


@pytest.fixture(scope="module")
def registries(contexts):
    jreg, treg = contexts[0].registry, contexts[1].registry
    for name in ("verts_full", "verts_full_mask", "diameter", "shift", "is_symmetric"):
        np.testing.assert_array_equal(_np(getattr(treg, name)), np.asarray(getattr(jreg, name)))
    return jreg, treg


def _jax_rotation(aa):
    return np.asarray(JT.axis_angle_to_matrix(aa))


def _rts(rng, n, spread=0.05, angle=1.0):
    """Camera-frame (n, 3, 4) ground-truth poses ~0.6 m out and predictions near them."""
    return rts(rng, n, _jax_rotation, spread, angle)


# ---- config -----------------------------------------------------------------------------


def test_parser_matches_jax():
    actions = lambda p: {a.dest: a for a in p._actions}
    ref, got = actions(jconfig.build_parser()), actions(tconfig.build_parser())
    assert set(ref) == set(got)
    for dest, a in ref.items():
        b = got[dest]
        for attr in ("option_strings", "default", "type", "choices", "nargs", "const"):
            assert getattr(a, attr) == getattr(b, attr), (dest, attr)
        assert type(a).__name__ == type(b).__name__, dest


@pytest.mark.parametrize("argv", [[], ["--mode", "eval", "--do_physics_selection",
                                       "--remove_pretrained_keys", "a", "b",
                                       "--brightness", "0.5", "1.5", "--ode_method", "rk4"]])
def test_get_config_matches_jax(argv):
    ref, got = jconfig.get_config(argv), tconfig.get_config(argv)
    assert dataclasses.asdict(ref) == dataclasses.asdict(got)
    mc = dataclasses.asdict(got.to_model_config())
    jmc = dataclasses.asdict(ref.to_model_config())
    assert mc == {k: jmc[k] for k in mc}
    with pytest.raises(SystemExit):
        tconfig.get_config(["--no_such_flag", "1"])


# ---- transforms and heads -----------------------------------------------------------------


def test_rigid_align_and_pose_helpers():
    rng = np.random.RandomState(0)
    A = (rng.randn(5, 21, 3) * 0.05).astype(np.float32)
    R = np.asarray(JT.axis_angle_to_matrix(rng.randn(5, 3).astype(np.float32)))
    B = (1.3 * np.einsum("nij,nkj->nki", R, A) + rng.randn(5, 21, 3) * 0.004 + 0.3
         ).astype(np.float32)
    B[0] = -B[0]                                   # a reflection: the det < 0 branch
    close(TT.rigid_align(_t(A), _t(B)), jax.vmap(JT.rigid_align)(A, B), atol=1e-6)
    d9 = np.concatenate([rng.randn(5, 6), rng.randn(5, 3) * 0.1], -1).astype(np.float32)
    m = np.asarray(JT.obj_9d_to_mat(d9))
    close(TT.obj_9d_to_mat(_t(d9)), m)
    close(TT.obj_mat_to_9d(_t(m)), JT.obj_mat_to_9d(m))
    m2 = np.asarray(JT.obj_9d_to_mat(d9[::-1].copy()))
    close(TT.matmul_for_rt(_t(m), _t(m2)), JT.matmul_for_rt(m, m2))
    mano = (rng.randn(4, 58) * 0.4).astype(np.float32)
    d6 = np.asarray(JT.mano_aa_to_6d(mano))
    close(TT.mano_aa_to_6d(_t(mano)), d6)
    close(TT.mano_6d_to_aa(_t(d6)), JT.mano_6d_to_aa(d6), atol=1e-5)
    pts = (rng.randn(4, 7, 3) * 0.1 + [0, 0, 0.6]).astype(np.float32)
    K = np.tile(np.array([[300.0, 0, 128], [0, 290.0, 120], [0, 0, 1]], np.float32), (4, 1, 1))
    close(TT.project_pt3d_to_pt2d(_t(pts), _t(K)[:, None]),
          JT.project_pt3d_to_pt2d(pts, K[:, None]))
    uvd = np.concatenate([rng.rand(4, 7, 2) * 200, rng.rand(4, 7, 1) + 0.3], -1).astype(np.float32)
    close(TT.inverse_project_uvd_to_xyz(_t(uvd), _t(K)[:, None]),
          JT.inverse_project_uvd_to_xyz(uvd, K[:, None]))


def test_power_quaternion_mean():
    rng = np.random.RandomState(1)
    aa = (rng.randn(6, 1, 3) * 0.8 + rng.randn(6, 9, 3) * 0.2).astype(np.float32)
    q = np.asarray(JT.axis_angle_to_quaternion(aa))
    w = rng.rand(6, 9).astype(np.float32)
    A = np.einsum("bni,bnj->bij", q, q) / 9.0
    close(TT.dominant_eigvec_4x4_power(_t(A)), JT.dominant_eigvec_4x4_power(A))
    for W in (w, None):
        ref = JT.average_quaternion(q, W, impl="power")
        close(TT.average_quaternion(_t(q), None if W is None else _t(W), impl="power"), ref)
        close(TT.average_quaternion(_t(q), None if W is None else _t(W), impl="eigh"), ref,
              atol=1e-5)
    impl = TT.QUAT_MEAN_IMPL
    try:
        TT.set_quat_mean_impl("power")
        close(TT.average_quaternion(_t(q), _t(w)), JT.average_quaternion(q, w, impl="power"))
        with pytest.raises(ValueError):
            TT.set_quat_mean_impl("qr")
    finally:
        TT.set_quat_mean_impl(impl)


def test_axsym_pose(registries):
    jreg, treg = registries
    rng = np.random.RandomState(2)
    shift = np.asarray(JT.obj_9d_to_mat(np.concatenate(
        [rng.randn(21, 6), rng.randn(21, 3) * 0.02], -1).astype(np.float32)))
    jreg = jreg._replace(shift=jnp.asarray(shift))
    treg = treg._replace(shift=_t(shift))
    pose = np.concatenate([rng.randn(5, 6), rng.randn(5, 3) * 0.1], -1).astype(np.float32)
    ids = rng.randint(0, 21, 5).astype(np.int32)
    ax = np.asarray(jheads.to_axsym_pose(jreg, pose, ids))
    close(theads.to_axsym_pose(treg, _t(pose), _t(ids)), ax)
    close(theads.to_cam_pose(treg, _t(ax), _t(ids)), jheads.to_cam_pose(jreg, ax, ids))


# ---- fixture ------------------------------------------------------------------------------


def test_heatmaps_and_fixture_keys(contexts):
    rng = np.random.RandomState(3)
    pt = (rng.rand(3, 21, 2) * 80 + 10).astype(np.float32)
    bbox = np.array([[5, 8, 90, 70], [0, 0, 64, 120], [20, 10, 60, 100]], np.float32)
    close(theatmap.adaptive_bbox_heatmap(_t(pt), _t(bbox), 64, 2.0),
          jheatmap.adaptive_bbox_heatmap(pt, bbox, 64, 2.0))
    close(theatmap.square_bbox_heatmap(_t(pt), _t(bbox), 64, 2.0),
          jheatmap.square_bbox_heatmap(pt, bbox, 64, 2.0))
    jctx, tctx = contexts
    ref = jax_make_batch(jctx, jax.random.PRNGKey(8), 2, 64)
    for signal in (False, True):
        got = tfix.make_arrays(tctx, 0, 2, 64, signal=signal)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].shape == v.shape and got[k].dtype.kind == np.asarray(v).dtype.kind, k
    # the fixture's ground truth is self-consistent: FK of gt_mano gives its vertices
    close(TV.hand_verts_meters(tctx.mano, _t(got["gt_mano"][:, :48]), _t(got["gt_mano"][:, 48:]))[0],
          got["gt_hand_vert_flip"], atol=1e-6)


# ---- metrics ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def metric_inputs():
    return _metric_inputs(_jax_rotation)


def test_hand_metrics(metric_inputs):
    a = metric_inputs
    keys = ("gt_joint", "pd_joint", "gt_vert", "pd_vert")
    ref = jax.jit(JM.hand_metrics)(*[a[k] for k in keys])
    got = TM.hand_metrics(*[_t(a[k]) for k in keys])
    assert set(ref) == set(got)
    for k in ref:
        close(got[k], ref[k], atol=0)


def test_object_metrics(registries, metric_inputs):
    jreg, treg = registries
    a = metric_inputs
    keys = ("pd_rt", "gt_rt", "obj_ids", "cam")
    ref = jax.jit(lambda *x: JM.object_metrics(jreg, *x))(*[a[k] for k in keys])
    got = TM.object_metrics(treg, *[_t(a[k]) for k in keys])
    assert set(ref) == set(got)
    for k in ref:
        r = np.asarray(ref[k])
        r = np.diagonal(r) if r.ndim == 2 else r          # REP, REP5: JAX's (N, N)
        if k in TTE.RATE_KEYS or k.startswith("FSCORE@"):
            np.testing.assert_array_equal(_np(got[k]), r, err_msg=k)
        else:
            close(got[k], r, atol=0)


def test_metrics_chunking_changes_nothing(registries, metric_inputs):
    _, treg = registries
    a = {k: _t(metric_inputs[k])[:2] for k in ("pd_rt", "gt_rt", "obj_ids", "cam")}
    one = TM.object_metrics(treg, *a.values(), chunk=1)
    whole = TM.object_metrics(treg, *a.values(), chunk=2)
    for k in one:
        torch.testing.assert_close(one[k], whole[k], rtol=0, atol=0)


def test_smce(registries, metric_inputs):
    jreg, treg = registries
    a = metric_inputs
    rng = np.random.RandomState(5)
    sym_R = np.array(JT.axis_angle_to_matrix(rng.randn(21, 5, 3) * 0.3))
    sym_R[:, 0] = np.eye(3)
    sym_t = rng.randn(21, 5, 3) * 0.01
    ref = jax.jit(lambda *x: JM.smce(jreg, sym_R, sym_t, *x))(a["pd_rt"], a["gt_rt"], a["obj_ids"])
    got = TM.smce(treg, sym_R, sym_t, _t(a["pd_rt"]), _t(a["gt_rt"]), _t(a["obj_ids"]))
    close(got, ref, atol=0)
    R0, t0 = TM.load_bop_symmetries("no/such/file.json")
    Rj, tj = JM.load_bop_symmetries("no/such/file.json")
    np.testing.assert_array_equal(R0, Rj)
    np.testing.assert_array_equal(t0, tj)


# ---- testers ------------------------------------------------------------------------------


def _tester_rows(jreg, seed):
    """The JAX testers fed three batches (the last one padded) on one shared camera.  The
    batches are of one size: JAX's (N, N) REP rows concatenate only then."""
    rng = np.random.RandomState(seed)
    jt_h, jt_o = JTE.TesterHand(), JTE.TesterObject(jreg)
    n = 4
    for last in (False, False, True):
        pd_rt, gt_rt = _rts(rng, n)
        ids = rng.choice([0, 3, 18], n).astype(np.int32)         # 18: the excluded clamp
        K = np.tile(np.array([[300.0, 0, 128], [0, 300.0, 128], [0, 0, 1]], np.float32), (n, 1, 1))
        gj = (rng.randn(n, 21, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
        gv = (rng.randn(n, 778, 3) * 0.05 + [0, 0, 0.6]).astype(np.float32)
        jt_h.add_batch(gj, (gj + rng.randn(n, 21, 3) * 0.01).astype(np.float32), gv,
                       (gv + rng.randn(n, 778, 3) * 0.01).astype(np.float32), rng.rand(n) > 0.4,
                       np.arange(n) < n - last)
        jt_o.add_batch(pd_rt, gt_rt, ids, K, np.arange(n) < n - last)
    return jt_h, jt_o


def test_testers_report_identically(registries):
    """The same metric rows give the same results and reports."""
    jreg, treg = registries
    jt_h, jt_o = _tester_rows(jreg, 6)
    tt_h, tt_o = TTE.TesterHand(), TTE.TesterObject(treg)
    tt_h._rows = [{k: torch.from_numpy(np.array(v)) for k, v in r.items()} for r in jt_h._rows]
    tt_o._rows = [{k: torch.from_numpy(np.array(np.diagonal(v) if v.ndim == 2 else v))
                   for k, v in r.items()} for r in jt_o._rows]
    assert tt_h.result() == jt_h.result()
    assert tt_h.report_mm() == jt_h.report_mm()
    ref, got = jt_o.report(), tt_o.report()
    assert list(ref) == list(got)
    for k in ref:
        if k not in ("REP", "REP5"):
            assert got[k] == ref[k], k
    # REP: the port's rows are JAX's per-sample diagonal; JAX also averages in the other
    # samples' columns, the padded one included.  average_instance leaves out the clamp (18)
    keep = np.concatenate([r["_valid"] & (r["obj_id"] != 18) for r in jt_o._rows])
    rep = np.concatenate([np.diagonal(r["REP"]) for r in jt_o._rows])[keep]
    assert got["REP"]["average_instance"] == int(float(rep.mean()) * 100) / 100
    assert TTE.TesterHand().result() == {} and TTE.TesterObject(treg).report() == {}


def test_testers_compute_on_their_inputs(registries, metric_inputs):
    """``add_batch`` on numpy or tensor inputs keeps the metrics of those inputs as rows."""
    _, treg = registries
    a = {k: v[:3] for k, v in metric_inputs.items()}
    t_h, t_o = TTE.TesterHand(), TTE.TesterObject(treg)
    t_h.add_batch(a["gt_joint"], _t(a["pd_joint"]), a["gt_vert"], a["pd_vert"], a["is_right"])
    t_o.add_batch(a["pd_rt"], a["gt_rt"], a["obj_ids"], _t(a["cam"]), [True, False, True])
    ref = TM.hand_metrics(*[_t(a[k]) for k in ("gt_joint", "pd_joint", "gt_vert", "pd_vert")])
    np.testing.assert_array_equal(t_h._cat()["PAMVE"], _np(ref["PAMVE"]))
    ref = TM.object_metrics(treg, *[_t(a[k]) for k in ("pd_rt", "gt_rt", "obj_ids", "cam")])
    np.testing.assert_array_equal(t_o._cat()["CD"], _np(ref["CD"])[[0, 2]])


def test_evaluate_prediction_pkl(registries, tmp_path):
    """A prediction pkl written by the JAX package's ``Trainer.dump_predictions`` re-scores
    to the JAX report."""
    jreg, treg = registries
    rng = np.random.RandomState(7)
    rows = []
    for n in (2, 2):
        pd_rt, gt_rt = _rts(rng, n)
        rows.append({"pd_obj_rt": pd_rt, "gt_obj_rt": gt_rt,
                     "obj_id": rng.randint(0, 21, n).astype(np.int32),
                     "pd_hand_vert": np.zeros((n, 778, 3), np.float16)})
    owner = types.SimpleNamespace(save_dir=str(tmp_path), logger=JTR.setup_logger(str(tmp_path)),
                                  cfg=types.SimpleNamespace(clean_data_mode="2023_CVPR_HFL"))
    JTR.Trainer.dump_predictions(owner, rows)
    path = str(tmp_path / "my-prediction_align-2023_CVPR_HFL.pkl")
    ref = JTE.evaluate_prediction_pkl(path, jreg)
    got = TTE.evaluate_prediction_pkl(path, treg)
    assert set(ref) == set(got)
    for k in ref:
        if k.startswith("REP"):
            assert got[k]["average_instance"] == ref[k]["average_instance"], k
        else:
            assert got[k] == ref[k], k


# ---- profiling, prefetch ------------------------------------------------------------------


def test_profiling_helpers(tmp_path):
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    out, cost = TP.flops_of(torch.matmul, a, b)
    assert torch.equal(out, a @ b)
    assert cost == {"flops": 2.0 * 8 * 16 * 4, "kernel_flops": 0.0}
    assert TP.param_count(torch.nn.Linear(3, 2)) == 8
    with TP.trace(str(tmp_path / "trace")) as tr:
        a @ b
    assert os.path.getsize(tr["path"]) > 0 and "aten::mm" in open(tr["path"]).read()


def test_prefetch_and_stager():
    batches = [{"a": np.full((2, 3), i, np.float64), "i": np.arange(2)} for i in range(4)]
    stager = DeviceStager(torch.device("cpu"))
    got = [stager.ready(s) for s in prefetch(batches, stager.stage)]
    assert [int(g["a"][0, 0]) for g in got] == [0, 1, 2, 3]
    assert got[0]["a"].dtype == torch.float32 and got[0]["i"].dtype == torch.int64

    def bad():
        yield {"a": np.zeros(1)}
        raise KeyError("boom")

    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(prefetch(bad()))


# ---- weights ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_variables(contexts):
    from test_torch_port_model import _random_variables

    batch = jax_make_batch(contexts[0], jax.random.PRNGKey(8), 2, 64)
    rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: JV.VPHONet().init(rngs, batch, False))
    return _random_variables(dict(shapes))


_LOAD_WITHOUT_JAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "vpho_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
try:
    import jax
    raise SystemExit("jax imported")
except ImportError:
    pass
import torch
from vpho_tpu_torch.models.vpho import VPHONet
from vpho_tpu_torch.utils.weights import load_pretrain
model = VPHONet()
rep = load_pretrain(model, sys.argv[1], sys.argv[2:])
print(len(rep["imported"]), len(rep["missing"]),
      repr(sum(float(v.double().abs().sum()) for v in model.state_dict().values())))
"""


def test_jax_final_model_loads_without_jax(jax_variables, tmp_path):
    """``Trainer.save_model``'s pickle (device_get of the Flax trees) loads strictly, 982
    keys, in a process where importing jax fails; prefixes drop subtrees."""
    v = jax_variables
    state = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, v["params"]),
                                  batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                                  buffers=jax.tree.map(jnp.asarray, v["buffers"]))
    owner = types.SimpleNamespace(save_dir=str(tmp_path), state=state,
                                  logger=JTR.setup_logger(str(tmp_path)))
    JTR.Trainer.save_model(owner)
    path = str(tmp_path / "final_model.pkl")
    ref = TV.VPHONet()
    ref.load_state_dict(state_dict_from_jax(v), strict=True)
    ref_sum = sum(float(t.double().abs().sum()) for t in ref.state_dict().values())
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    run = lambda *keys: subprocess.run(
        [sys.executable, "-c", _LOAD_WITHOUT_JAX, path, *keys], check=True, timeout=300,
        capture_output=True, text=True, env=env).stdout.split()
    n_loaded, n_missing, total = run()
    assert (int(n_loaded), int(n_missing)) == (982, 0)
    assert float(total) == ref_sum
    n_loaded, n_missing, _ = run("denoiser_hand", "head_mano/Dense_0")
    assert int(n_loaded) + int(n_missing) == 982 and int(n_missing) == 11 + 2
    with open(path, "rb") as f:
        assert set(pickle.load(f)) == {"params", "batch_stats", "buffers"}
