"""The check catches what it is there to catch, at a size the CPU holds: a whole run with the
timed path broken underneath (``run.run_cell``, past the look for a card) comes out not
correct under each cell's limits, and so does the control (the reference one precision below
the configuration's, in the program's place).  A sound run of an eval cell comes out correct."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import readings, run
from benchmark.tests.tiny import tiny_spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def _run(workload, pool=2, batch_size=2):
    spec = tiny_spec(workload, pool=pool, batch_size=batch_size)
    return run.run_cell(spec, SEED, 1.0, False, CPU, time.perf_counter())


def _altered(real):
    def forward_predict(model, ctx, batch, x0=None, **kw):
        pd = real(model, ctx, batch, x0=x0, **kw)
        pd["agg_hand_joint"] = pd["agg_hand_joint"].clone()
        pd["agg_hand_joint"][0] += 0.05                   # 5 cm on one frame's answer
        return pd
    return forward_predict


def _altered_rows(share):
    """The answers of the first ``share`` of each batch's rows moved 5 cm, hand and object."""
    def fault(real):
        def forward_predict(model, ctx, batch, x0=None, **kw):
            pd = real(model, ctx, batch, x0=x0, **kw)
            k = int(share * batch["rgb"].shape[0]) + 1
            for key in ("agg_hand_joint", "agg_obj_6d"):
                pd[key] = pd[key].clone()
            pd["agg_hand_joint"][:k] += 0.05
            pd["agg_obj_6d"][:k, 6:] += 0.05                  # the object's translation
            return pd
        return forward_predict
    return fault


def _half_predict(real):
    def forward_predict(model, ctx, batch, x0=None, **kw):
        n = batch["rgb"].shape[0]
        if n == 1:
            return real(model, ctx, batch, x0=x0 * 0.5, **kw)
        half = {k: v[: n // 2] for k, v in batch.items()}
        pd = real(model, ctx, half, x0=x0[: x0.shape[0] // 2], **kw)
        return {k: torch.cat([v, v], 0) if torch.is_tensor(v) and v.shape[:1] == (n // 2,)
                else v for k, v in pd.items()}
    return forward_predict


@pytest.mark.parametrize("workload", ["eval-dexycb-bs64", "infer-frame-bs1"])
def test_sound_eval_run_is_correct(workload):
    out = _run(workload)
    assert out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_altered, _half_predict], ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("workload", ["eval-dexycb-bs64", "infer-frame-bs1"])
def test_broken_eval_is_not_correct(monkeypatch, workload, fault):
    from vpho_tpu_torch.models import vpho as V

    monkeypatch.setattr(V, "forward_predict", fault(V.forward_predict))
    out = _run(workload)
    assert not out["result"]["correct"], out["checks"]


def test_rows_altered_at_batch_64_are_not_correct(monkeypatch):
    """At the eval cell's batch of 64, a fault on just more than the far share's limit of each
    batch's rows, far fewer than half, comes out not correct: the far share fails while the
    median frame's gaps stay within their limits."""
    from vpho_tpu_torch.models import vpho as V

    share = tiny_spec("eval-dexycb-bs64").cell["limits"]["hand_far_share"]
    assert share < 0.45
    monkeypatch.setattr(V, "forward_predict", _altered_rows(share)(V.forward_predict))
    out = _run("eval-dexycb-bs64", pool=1, batch_size=64)
    checks = out["checks"]
    assert not out["result"]["correct"], checks
    assert checks["hand_far_share"][0] > checks["hand_far_share"][1], checks
    for median in ("hand_joint_gap_p50_mm", "obj_pose_gap_p50_mm"):
        assert checks[median][0] <= checks[median][1], checks


def test_train_state_unchanged_is_not_correct(monkeypatch):
    from vpho_tpu_torch.engine import trainer as TR

    monkeypatch.setattr(TR.Optimizer, "step", lambda self, grads: bool(self.advance()))
    monkeypatch.setattr(TR.Optimizer, "apply", lambda self, grads=None: None)
    out = _run("train-dexycb-bs64", pool=4)
    assert not out["result"]["correct"], out["checks"]


def test_train_half_batch_is_not_correct(monkeypatch):
    from vpho_tpu_torch.models import vpho as V

    real = V.forward_train

    def forward_train(model, ctx, batch, draws=None, dropout=None, generator=None, rows=None):
        n = int(batch["rgb"].shape[0])
        half = {k: v[: n // 2] for k, v in batch.items()}
        return real(model, ctx, half, draws=draws, dropout=dropout, generator=generator,
                    rows=(0, n // 2, n))

    monkeypatch.setattr(V, "forward_train", forward_train)
    out = _run("train-dexycb-bs64", pool=4)
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("workload", ["eval-dexycb-bs64", "infer-frame-bs1", "train-dexycb-bs64"])
def test_control_is_not_correct(workload):
    spec = tiny_spec(workload, pool=4 if workload.startswith("train") else 2)
    fn = readings.train_reading if workload.startswith("train") else readings.eval_reading
    numbers = fn(spec, SEED, CPU, "control")
    assert any(not numbers[n] <= lim for n, lim in spec.cell["limits"].items()), numbers
