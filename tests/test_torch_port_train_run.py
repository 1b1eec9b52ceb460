"""``run(cfg, device="cpu")`` with ``--mode train`` on the synthetic stream at a tiny size: the
files an epoch writes (``checkpoint/epoch_1.state``, ``final_model.pkl``, the log), the
``--start_with_eval`` sub-eval, ``final_model.pkl`` read back by ``--pretrain``, and a resume
from ``epoch_1.state`` that restores params, BN statistics, optimizer state and step exactly and
trains the next epoch.  The JAX side of one train step is in ``test_torch_port_train.py``.
"""
import os

import numpy as np
import pytest
import torch

from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import runner as TR
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.models import vpho as TV

torch.set_num_threads(1)

TINY = ["--batch_size", "1", "--repeat_num", "2", "--patch_size", "64", "--eval_batch_size", "1",
        "--sample_num", "2", "--sampling_steps", "2", "--topk_hand", "1", "--topk_obj", "1",
        "--viz_freq", "-1", "--print_freq", "4"]


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    """One epoch, with the sub-eval before it; the constants are built once for every run."""
    out = str(tmp_path_factory.mktemp("train"))
    ctx = TV.make_context(TV.ModelConfig(repeat_num=2, patch_size=64, sample_num=2,
                                         sampling_steps=2, topk_hand=1, topk_obj=1),
                          device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(TV, "make_context", lambda *a, **k: ctx)
    argv = ["--mode", "train", "--max_epochs", "1", "--start_with_eval", "--output_dir", out]
    trainer = TR.run(get_config(argv + TINY), device="cpu")
    yield trainer, out
    mp.undo()


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def test_one_epoch_writes_checkpoint_and_final_model(first):
    trainer, _ = first
    assert _files(trainer.save_dir) == ["checkpoint/epoch_1.state", "final_model.pkl", "info.log"]
    assert trainer.step == 8 and trainer.optimizer.count == 8
    assert trainer.last_train["steps"] == 8 and len(trainer.last_train["losses"]) == 14
    assert all(np.isfinite(v) for v in trainer.last_train["losses"].values())
    log = open(os.path.join(trainer.save_dir, "info.log")).read()
    assert log.count("hand/regression:") == 2       # --start_with_eval, then the sub-eval
    assert "[0004/8] diff_hand:" in log and "Epoch 0 done" in log
    payload = torch.load(os.path.join(trainer.save_dir, "checkpoint", "epoch_1.state"),
                         weights_only=True)
    assert set(payload) == {"params", "batch_stats", "buffers", "opt_state", "step"}
    assert payload["step"] == 8 and payload["opt_state"]["count"] == 8
    assert len(payload["params"]) + len(payload["batch_stats"]) + len(payload["buffers"]) == 982


def test_final_model_loads_as_pretrain(first, tmp_path):
    trainer, _ = first
    cfg = get_config(["--mode", "eval", "--output_dir", str(tmp_path), "--pretrain",
                      os.path.join(trainer.save_dir, "final_model.pkl")] + TINY)
    other = TT.Trainer(cfg, device="cpu")
    other.init_state()
    got, ref = other.model.state_dict(), trainer.model.state_dict()
    for k, v in ref.items():
        assert torch.equal(got[k], v) or k.endswith("num_batches_tracked"), k


def test_resume_restores_the_state_and_trains_on(first):
    trainer, out = first
    ckpt = os.path.join(trainer.save_dir, "checkpoint", "epoch_1.state")
    cfg = get_config(["--mode", "train", "--max_epochs", "2", "--checkpoint", ckpt,
                      "--output_dir", out] + TINY)
    resumed = TT.Trainer(cfg, device="cpu")
    resumed.init_state(8)
    assert resumed.start_epoch == 1 and resumed.step == 8
    ref, got = trainer.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ref.items())
    a, b = trainer.optimizer, resumed.optimizer
    assert (b.count, b.mini_step) == (a.count, a.mini_step)
    assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))

    run2 = TR.run(cfg, device="cpu")
    assert run2.step == 16 and run2.optimizer.count == 16
    assert _files(run2.save_dir) == ["checkpoint/epoch_2.state", "final_model.pkl", "info.log"]
    log = open(os.path.join(run2.save_dir, "info.log")).read()
    assert "Epoch 1/2" in log and "Epoch 0/2" not in log
