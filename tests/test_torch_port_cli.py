"""``run(cfg, device="cpu")`` against the JAX package's ``run(cfg)`` for infer_candidate and
eval_path (the files written, the pkl rows, the re-scored report); the runs the port still
refuses; and the ``vpho_tpu_torch.cli`` entry point.  The JAX runs reuse what
``test_torch_port_runner.runners`` caches across runs.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from vpho_tpu.engine import trainer as JTR
from test_torch_port_runner import SMALL, listing, runners, same_pkl_rows  # noqa: F401

torch.set_num_threads(1)


def test_infer_candidate(runners):
    jax_run, torch_run = runners
    argv = ["--mode", "infer_candidate"] + SMALL
    ref_dir, got_dir = jax_run(argv), torch_run(argv)
    pkl = "my-candidates_align-2023_CVPR_HFL.pkl"
    assert listing(got_dir) == listing(ref_dir) == ["info.log", pkl]
    same_pkl_rows(ref_dir, got_dir, pkl)


def test_eval_path_rescores_a_jax_pkl(runners, tmp_path):
    """--eval_path on a prediction pkl that the JAX package's ``dump_predictions`` wrote."""
    jax_run, torch_run = runners
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(2):
        rt = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
                             (rng.randn(3, 3, 1) * 0.02 + [[0], [0], [0.6]])], -1)
        rows.append({"pd_obj_rt": (rt + rng.randn(3, 3, 4) * 0.01).astype(np.float32),
                     "gt_obj_rt": rt.astype(np.float32),
                     "obj_id": rng.randint(0, 21, 3).astype(np.int32)})
    owner = types.SimpleNamespace(save_dir=str(tmp_path), logger=JTR.setup_logger(str(tmp_path)),
                                  cfg=types.SimpleNamespace(clean_data_mode="2023_CVPR_HFL"))
    JTR.Trainer.dump_predictions(owner, rows)
    path = str(tmp_path / "my-prediction_align-2023_CVPR_HFL.pkl")
    ref, got = jax_run(["--eval_path", path]), torch_run(["--eval_path", path])
    assert list(ref) == list(got)
    for k in ref:
        if not k.startswith("REP"):     # JAX's REP averages over every camera of the batch
            assert got[k] == ref[k], k


def test_runs_the_port_refuses(runners, tmp_path):
    """What the port still refuses: the JAX package's orbax checkpoint directories, which it
    reads through the converter the message names (``--num_devices 2`` runs now:
    ``test_torch_port_ddp.py``); and --mode energy, which the reference never implemented."""
    _, torch_run = runners
    with pytest.raises(NotImplementedError, match="not rebuilt"):
        torch_run(["--mode", "energy"] + SMALL)
    (tmp_path / "epoch_3.state").mkdir()          # the JAX package's orbax directory
    for flags, match in ((["--checkpoint", str(tmp_path / "epoch_3.state")],
                          "orbax checkpoint directory.*python orbax_to_torch.py"),):
        with pytest.raises(NotImplementedError, match=match):
            torch_run(["--mode", "eval"] + SMALL + flags)


def test_cli_runs_on_the_gpu_by_default():
    """The entry point takes no device flag: without a GPU it stops and says how to get the
    CPU; with --help it lists the JAX CLI's flags."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    run = lambda *argv: subprocess.run([sys.executable, "-m", "vpho_tpu_torch.cli", *argv],
                                       capture_output=True, text=True, timeout=300, env=env)
    res = run("--mode", "eval", "--output_dir", "/nonexistent/never-written")
    assert res.returncode != 0 and "device='cpu'" in res.stderr
    res = run("--help")
    assert res.returncode == 0 and "--aggregation_mode_obj" in res.stdout
