"""Data parallelism of the port (``vpho_tpu_torch/parallel/mesh.py``): two gloo ranks on this
host, each a process running ``tests/torch_ddp_child.py``, against one rank (this process, no
process group) and the JAX package.

Case: bs 4 = 2 + 2, patch 64, repeat_num 2, the seeded weights of ``test_torch_port_train``
with non-zero denoiser heads, the JAX step's score-loss draws and dropout masks given to the
port at the global batch.  ``is_right`` is (1, 1, 0, 0): rank 0 holds both right hands, so the
right-hand shape term splits unevenly across the ranks.  That term is the sum over right hands
/ (10 B) for any count (the count cancels), so the mean of the ranks' terms is the global one
and nothing in it needs a reduction across ranks; this case holds the port to that.

Bars: those of ``test_torch_port_train`` (loss terms rtol 1e-4; gradients per parameter with
rtol 1e-3 for the heads, 1e-2 for the denoisers, 0.15 for the trunk and an absolute term of
1e-4 x the module's largest gradient norm; BN statistics 1e-3 x the tensor's largest value),
between the ranks and one rank and between the ranks and JAX; against JAX the two heatmap
loss terms get rtol 5e-4 (the heads end in train-mode BN; one rank of the port is 1.4e-4 and
1.8e-4 from JAX on this batch, and two ranks are as far).  Across the ranks the parameters
and BN statistics after the step are bit-identical.  An eval of a 5-frame batch (padded to 3 +
3) gathers to the one-rank report and rows exactly, and only rank 0 writes.
"""
import copy
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpho_tpu.data.fixtures import make_batch as jax_make_batch
from vpho_tpu.models import vpho as JV
from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine.runner import run
from vpho_tpu_torch.parallel import mesh
from vpho_tpu_torch.utils.weights import jax_variables_from_state_dict
from test_torch_port_train import CFG, DENOISERS, HEADS, _as_sd, _port_model, _score_draws
import torch_ddp_child as child

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _jax_step(model, is_right):
    """The JAX package's forward_train and gradients at bs 4, its dropout masks recorded."""
    jctx = JV.make_context(JV.ModelConfig(**CFG))
    jbatch = dict(jax_make_batch(jctx, jax.random.PRNGKey(8), 4, 64))
    jbatch["is_right"] = jnp.asarray(is_right)
    variables = jax.tree.map(jnp.asarray, jax_variables_from_state_dict(model.state_dict()))
    jmodel = JV.VPHONet()
    rng = jax.random.fold_in(jax.random.PRNGKey(1000), 0)
    masks, bernoulli = [], jax.random.bernoulli

    def recording(key, p=0.5, shape=None, **kw):
        m = bernoulli(key, p, shape, **kw)
        masks.append(m)
        return m

    def loss_fn(p):
        v = {"params": p, "batch_stats": variables["batch_stats"],
             "buffers": variables["buffers"]}
        total, loss_dt, mutated = JV.forward_train(jmodel, v, jctx, jbatch, rng)
        return total, (loss_dt, mutated["batch_stats"])

    def step(params):
        masks.clear()
        (_, (loss_dt, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss_dt, stats, grads, list(masks)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", recording)
    try:
        loss, stats, grads, masks = jax.jit(step)(variables["params"])
    finally:
        mp.undo()
    _, rng_hand, rng_obj = jax.random.split(rng, 3)
    draws = {"hand": _score_draws(rng_hand, 8, 96, jctx.sde.eps),
             "obj": _score_draws(rng_obj, 8, 9, jctx.sde.eps)}
    ref_stats = _as_sd(variables["params"], {"batch_stats": jax.tree.map(np.asarray, stats),
                                             "buffers": variables["buffers"]})
    return dict(batch={k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()},
                loss={k: float(v) for k, v in loss.items()},
                grads=_as_sd(grads, variables), stats=ref_stats,
                masks=[torch.from_numpy(np.array(m)) for m in masks], draws=draws)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("ddp"))
    model = _port_model()
    ref = _jax_step(model, np.array([True, True, False, False]))
    inputs = {"init_sd": copy.deepcopy(model.state_dict()), "batch": ref["batch"],
              "masks": ref["masks"], "draws": ref["draws"]}
    torch.save(inputs, os.path.join(wd, "inputs.pt"))
    port = mesh.free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_ddp_child.py"), wd,
                               str(port), str(r), "2"], env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        one = child.step_and_eval(inputs, os.path.join(wd, "one"))
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            p.kill()
    got = [torch.load(os.path.join(wd, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    shapes = [(k, p.shape) for k, p in model.named_parameters()]
    return dict(one=one, ranks=got, ref=ref, shapes=shapes, wd=wd)


def _split(flat, shapes):
    out, at = {}, 0
    for k, shape in shapes:
        n = int(np.prod(shape))
        out[k] = flat[at:at + n].reshape(shape)
        at += n
    return out


def _close_grads(got, ref):
    """``test_torch_port_train``'s gradient bars, per parameter."""
    group_of = lambda k: k.split(".")[0]
    scale = {}
    for k, r in ref.items():
        scale[group_of(k)] = max(scale.get(group_of(k), 0.0), float(np.linalg.norm(r)))
    for k, g in got.items():
        grp = group_of(k)
        rtol = 1e-3 if grp in HEADS else 1e-2 if grp in DENOISERS else 0.15
        r = np.asarray(ref[k])
        err = float(np.linalg.norm(np.asarray(g) - r))
        assert err <= rtol * float(np.linalg.norm(r)) + 1e-4 * scale[grp], (k, err)


def test_two_ranks_step_equals_one_rank_and_jax(ranks):
    """The gradient the optimizer sees on two ranks at 2 + 2 is the global batch's: it
    agrees with one rank at bs 4 and with JAX's, and the ranks' mean losses with both."""
    grads = _split(ranks["ranks"][0]["grads"], ranks["shapes"])
    _close_grads(grads, _split(ranks["one"]["grads"], ranks["shapes"]))
    _close_grads(grads, ranks["ref"]["grads"])
    mean = {k: (ranks["ranks"][0]["losses"][k] + ranks["ranks"][1]["losses"][k]) / 2
            for k in ranks["one"]["losses"]}
    for k, v in mean.items():
        np.testing.assert_allclose(v, ranks["one"]["losses"][k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(v, ranks["ref"]["loss"][k],
                                   rtol=5e-4 if k.startswith("hm_") else 1e-4, err_msg=k)


def test_right_hands_split_unevenly(ranks):
    """Rank 0 holds both right hands, rank 1 none: each rank's shape term differs from the
    global one, and their mean is the global term of one rank and of JAX."""
    r0, r1 = (r["losses"]["mano_shape_loss"] for r in ranks["ranks"])
    assert r1 == 0.0 and r0 > 0.0
    np.testing.assert_allclose((r0 + r1) / 2, ranks["one"]["losses"]["mano_shape_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose((r0 + r1) / 2, ranks["ref"]["loss"]["mano_shape_loss"],
                               rtol=1e-5)


def test_ranks_hold_identical_state(ranks):
    """After the step the parameters and BN statistics are the same bits on both ranks, and
    the statistics (moved by the global batch's) agree with one rank's and JAX's."""
    r0, r1 = ranks["ranks"]
    assert r0["params_digest"] == r1["params_digest"]
    assert r0["stats_digest"] == r1["stats_digest"]
    for ref in (ranks["one"]["stats"], ranks["ref"]["stats"]):
        for k, v in r0["stats"].items():
            if k.endswith("num_batches_tracked"):
                continue
            r = np.asarray(ref[k])
            assert float(np.abs(v.numpy() - r).max()) <= 1e-3 * float(np.abs(r).max()), k


def test_eval_is_padded_gathered_and_written_once(ranks):
    """5 frames over 2 ranks: 3 + 3 rows with the last masked; the gathered report and dump
    rows are one rank's, and only rank 0 wrote files (rank 1 ran with writes refused)."""
    one, (r0, r1) = ranks["one"], ranks["ranks"]
    assert r0["report"] == r1["report"] == one["report"]
    assert [sorted(r) for r in r0["rows"]] == [sorted(r) for r in one["rows"]]
    for a, b in zip(r0["rows"], one["rows"]):
        assert len(a["index"]) == 5
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert r0["save_dir"] == r1["save_dir"]
    assert sorted(os.listdir(r0["save_dir"])) == sorted(os.listdir(one["save_dir"]))


def test_num_devices_spawns_ranks(tmp_path):
    """``--num_devices 2`` through ``run`` on the CPU spawns two gloo ranks, which evaluate
    two batches of 3 (padded to 2 + 2) and write rank 0's files."""
    code = ("from vpho_tpu_torch.configs.config import get_config;"
            "from vpho_tpu_torch.engine.runner import run;"
            "import sys; assert run(get_config(sys.argv[1:]), device='cpu') is None")
    argv = ["--mode", "eval", "--patch_size", "64", "--eval_batch_size", "3", "--sample_num",
            "2", "--sampling_steps", "1", "--topk_hand", "1", "--topk_obj", "1", "--viz_freq",
            "-1", "--num_devices", "2", "--output_dir", str(tmp_path)]
    res = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT,
                                               OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    (run_dir,) = os.listdir(tmp_path)
    assert sorted(os.listdir(tmp_path / run_dir)) == ["info.log",
                                                      "my-prediction_align-2023_CVPR_HFL.pkl"]
    with open(tmp_path / run_dir / "my-prediction_align-2023_CVPR_HFL.pkl", "rb") as f:
        rows = pickle.load(f)
    assert [list(r["index"]) for r in rows] == [[0, 1, 2], [3, 4, 5]]


def test_requests_that_cannot_run_raise(monkeypatch):
    """More devices than visible cards, or an explicit world without its rank and address,
    raise; a world of 1 from the environment stays single-process."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="num_devices 2"):
        mesh.resolve_num_devices(2, torch.device("cuda"))
    assert mesh.resolve_num_devices(0, torch.device("cuda")) == 1
    with pytest.raises(ValueError, match="rank_"):
        mesh.init_distributed(torch.device("cpu"), world=2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed(torch.device("cpu")) == torch.device("cpu")
    assert not mesh.is_distributed()
    with pytest.raises(ValueError, match="divisible"):
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
        run(get_config(["--mode", "train", "--batch_size", "3", "--num_devices", "1",
                        "--output_dir", "/nonexistent/never-written"]), device="cpu")
