"""``Trainer.evaluate`` end to end: the port against the JAX package's trainer.

Both trainers share the weights (``_random_variables``: every tensor non-zero, heatmap heads
biased to positive heat), get the same synthetic eval batches from the JAX stream with bboxes
wider than the crop (every candidate inside its heatmap, see ``test_forward_predict_matches_jax``)
and the JAX package's own ODE start states (``x0_for``: ``sde.prior`` on
``fold_in(PRNGKey(128), i)``, as its evaluate draws them).  Test size: patch 64, bs 4, S 3,
4 dpm3m steps, topk 2/2, two batches, the second with a padded tail sample.

Bars: per-sample hand and object distances within 1e-3 m; the rate columns equal wherever JAX's
value is more than 1e-3 from its threshold; the prediction pkl rows with the same keys, dtypes
and index column; the same viz files.
"""
import os
import types

import jax
import numpy as np
import optax
import pytest
import torch

from vpho_tpu.configs.config import get_config as jax_get_config
from vpho_tpu.engine import profiling as JP
from vpho_tpu.engine import runner as JR
from vpho_tpu.engine import trainer as JTR
from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import trainer as TTR
from vpho_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_model import _random_variables

torch.set_num_threads(1)

ARGV = ["--mode", "eval", "--eval_batch_size", "4", "--sample_num", "3", "--sampling_steps",
        "4", "--patch_size", "64", "--topk_hand", "2", "--topk_obj", "2", "--viz_freq", "1",
        "--num_devices", "1"]
WIDE = np.array([-100.0, -100.0, 164.0, 164.0], np.float32)


def _capture(module, monkeypatch):
    """Record every tester the module's evaluate builds, by key order of creation."""
    made = []
    for name in ("TesterHand", "TesterObject"):
        class Recorded(getattr(module, name)):
            def __init__(self, *args):
                super().__init__(*args)
                made.append(self)

        monkeypatch.setattr(module, name, Recorded)
    return made


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("eval"))
    mp = pytest.MonkeyPatch()
    try:
        jcfg = jax_get_config(ARGV + ["--output_dir", os.path.join(out, "jax")])
        jt = JTR.Trainer(jcfg)
        batches = list(JR.synthetic_stream(jt.ctx, jcfg, 2, 4, seed=9999, with_eval_keys=True))
        for b in batches:
            for k in ("bbox_hand", "bbox_hand_rect", "bbox_obj", "bbox_obj_rect"):
                b[k] = np.tile(WIDE, (4, 1))
        batches[1]["_valid"] = np.array([True, True, True, False])
        sample = {k: v for k, v in batches[0].items() if not k.startswith("_")}
        rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
        variables = _random_variables(dict(jax.eval_shape(
            lambda: jt.model.init(rngs, sample, False))))
        jt.state = JTR.TrainState.create(
            apply_fn=jt.model.apply, params=variables["params"], tx=optax.sgd(0.0),
            batch_stats=variables["batch_stats"], buffers=variables["buffers"])
        # the JAX evaluate's batch-0 cost analysis compiles the whole graph a second time
        mp.setattr(JP, "flops_of", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("off")))
        jax_testers = _capture(JTR, mp)
        ref = jt.evaluate([dict(b) for b in batches])
        jt.dump_predictions(ref["collector_res"])
        ref_pkl = os.path.join(jt.save_dir, "my-prediction_align-2023_CVPR_HFL.pkl")

        tcfg = get_config(ARGV + ["--output_dir", os.path.join(out, "torch")])
        tt = TTR.Trainer(tcfg, device="cpu")
        tt.init_state()
        tt.model.load_state_dict(state_dict_from_jax(variables), strict=True)
        torch_testers = _capture(TTR, mp)
        sde, S, T0 = jt.ctx.sde, jcfg.sample_num, jcfg.sample_T0
        x0_for = lambda i, n: np.array(sde.prior(
            jax.random.fold_in(jax.random.PRNGKey(128), i), (n * S, 105), T=T0))
        got = tt.evaluate([dict(b) for b in batches], x0_for=x0_for)
        got_pkl = tt.dump_predictions(got["collector_res"])
    finally:
        mp.undo()
    return types.SimpleNamespace(ref=ref, got=got, jt=jt, tt=tt, ref_pkl=ref_pkl,
                                 got_pkl=got_pkl, jax_testers=jax_testers,
                                 torch_testers=torch_testers, registry=jt.ctx.registry)


def _rows(tester):
    rows = tester._rows
    out = {}
    for k in rows[0]:
        vals = [np.asarray(r[k].cpu() if isinstance(r[k], torch.Tensor) else r[k]) for r in rows]
        out[k] = np.concatenate([np.diagonal(v) if v.ndim == 2 and k.startswith("REP") else v
                                 for v in vals])
    return out


HAND_KEYS = ("MJE", "PA_MJE", "MVE", "PAMVE", "JE")
OBJ_DIST_KEYS = ("MCE", "MCE2", "OCE", "ADD", "ADDS", "CD")


def test_per_sample_metrics(runs):
    assert len(runs.jax_testers) == len(runs.torch_testers) == 5
    diameter = np.asarray(runs.registry.diameter)
    for jt, tt in zip(runs.jax_testers, runs.torch_testers):
        ref, got = _rows(jt), _rows(tt)
        assert set(ref) == set(got)
        np.testing.assert_array_equal(got["_valid"], ref["_valid"])
        if "MJE" in ref:
            for k in HAND_KEYS:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3, err_msg=k)
            continue
        for k in OBJ_DIST_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3, err_msg=k)
        thresholds = {"ADD01d": ("ADD", 0.1 * diameter[ref["obj_id"]]),
                      "ADDS01d": ("ADDS", 0.1 * diameter[ref["obj_id"]]), "REP5": ("REP", 5.0)}
        for k, (base, th) in thresholds.items():
            clear = np.abs(ref[base] - th) > 1e-3
            np.testing.assert_array_equal(got[k][clear], ref[k][clear], err_msg=k)


def test_prediction_pkl_rows(runs):
    import pickle

    with open(runs.ref_pkl, "rb") as f:
        ref = pickle.load(f)
    with open(runs.got_pkl, "rb") as f:
        got = pickle.load(f)
    assert os.path.basename(runs.ref_pkl) == os.path.basename(runs.got_pkl)
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            assert np.asarray(g[k]).shape == np.asarray(r[k]).shape, k
        np.testing.assert_array_equal(g["index"], r["index"])
        np.testing.assert_array_equal(g["obj_id"], r["obj_id"])
        np.testing.assert_allclose(g["pd_obj_rt"], r["pd_obj_rt"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(g["pd_hand_joint"], r["pd_hand_joint"], rtol=0, atol=5e-4)
    assert [len(r["index"]) for r in got] == [4, 3]


def test_reports_and_files(runs):
    ref, got = runs.ref["report"], runs.got["report"]
    for group in ("hand", "object"):
        assert list(ref[group]) == list(got[group])
        for variant in ref[group]:
            assert set(ref[group][variant]) == set(got[group][variant])
            for metric in ref[group][variant]:
                assert set(ref[group][variant][metric]) == set(got[group][variant][metric])
    listing = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)
                               for r, _, fs in os.walk(d) for f in fs)
    assert listing(runs.tt.save_dir) == listing(runs.jt.save_dir)
    timing = runs.got["timing"]
    assert timing["frames"] == [4, 3] and len(timing["predict_s"]) == 2
