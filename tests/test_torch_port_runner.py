"""``run(cfg, device="cpu")`` against the JAX package's ``run(cfg)``: the files each mode
writes, and the rows of its pkl (keys, dtypes, shapes, index column), for eval (with the viz
dumps on every batch) and infer.  infer_candidate, eval_path, the refusals and the CLI are in
``test_torch_port_cli.py``.

The JAX runs reuse one compiled predict (and candidate) step, one set of constants and one
set of random weights across modes: the files and row layouts do not depend on them, and a
compile per run would cost tens of seconds on one core.
"""
import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from vpho_tpu.configs.config import get_config as jax_get_config
from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.engine import profiling as JP
from vpho_tpu.engine import runner as JR
from vpho_tpu.engine import trainer as JTR
from vpho_tpu.models import vpho as JV
from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import runner as TR
from vpho_tpu_torch.models import vpho as TV
from test_torch_port_model import _random_variables

torch.set_num_threads(1)

SMALL = ["--eval_batch_size", "1", "--sample_num", "2", "--sampling_steps", "2",
         "--patch_size", "64", "--topk_hand", "1", "--topk_obj", "1", "--num_devices", "1"]


def _once(cache, name, make):
    def made(*args, **kwargs):
        if name not in cache:
            cache[name] = make(*args, **kwargs)
        return cache[name]
    return made


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(jax_run(argv), torch_run(argv)): each returns its run's output directory (or the
    eval_path report)."""
    out = str(tmp_path_factory.mktemp("runs"))
    cache = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(JTR, "make_predict_step", _once(cache, "predict", JTR.make_predict_step))
    mp.setattr(JTR, "make_candidate_step", _once(cache, "candidate", JTR.make_candidate_step))
    mp.setattr(JV, "make_context", _once(cache, "jctx", JV.make_context))
    mp.setattr(TV, "make_context", _once(cache, "tctx", TV.make_context))
    mp.setattr(JP, "flops_of", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("off")))

    def init_state(self, sample_batch, steps_per_epoch):
        if "vars" not in cache:
            batch = jax_make_batch(self.ctx, jax.random.PRNGKey(8), 2, 64)
            rngs = {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
            cache["vars"] = _random_variables(dict(jax.eval_shape(
                lambda: self.model.init(rngs, batch, False))))
        v = cache["vars"]
        self.state = JTR.TrainState.create(apply_fn=self.model.apply, params=v["params"],
                                           tx=optax.sgd(0.0), batch_stats=v["batch_stats"],
                                           buffers=v["buffers"])

    mp.setattr(JTR.Trainer, "init_state", init_state)

    def jax_run(argv):
        res = JR.run(jax_get_config(argv + ["--output_dir", os.path.join(out, "jax")]))
        return res if isinstance(res, dict) else res.save_dir

    def torch_run(argv):
        res = TR.run(get_config(argv + ["--output_dir", os.path.join(out, "torch")]),
                     device="cpu")
        return res if isinstance(res, dict) else res.save_dir

    yield jax_run, torch_run
    mp.undo()


def listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def same_pkl_rows(ref_dir, got_dir, name):
    with open(os.path.join(ref_dir, name), "rb") as f:
        ref = pickle.load(f)
    with open(os.path.join(got_dir, name), "rb") as f:
        got = pickle.load(f)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            assert np.asarray(g[k]).shape == np.asarray(r[k]).shape, k
        np.testing.assert_array_equal(g["index"], r["index"])
    return ref, got


@pytest.mark.parametrize("mode,pkl", [
    ("eval", "my-prediction_align-2023_CVPR_HFL.pkl"),
    ("infer", "my-prediction_align-2023_CVPR_HFL-infer.pkl")])
def test_run_writes_the_jax_files(runners, mode, pkl):
    jax_run, torch_run = runners
    argv = ["--mode", mode] + SMALL + (["--viz_freq", "1"] if mode == "eval" else [])
    ref_dir, got_dir = jax_run(argv), torch_run(argv)
    assert listing(got_dir) == listing(ref_dir)
    assert pkl in listing(got_dir)
    ref, _ = same_pkl_rows(ref_dir, got_dir, pkl)
    assert len(ref) == (2 if mode == "eval" else 4)
