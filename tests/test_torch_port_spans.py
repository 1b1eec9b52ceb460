"""The port's own measurement on the CPU: host spans that a profiler sees and nothing else does
(``engine/profiling.py``), and the predict step's stage marks (``utils/marks.py``) read into
``evaluate``'s timing.

Test size: patch 64, bs 2, S 2, one dpm3m step, topk 1/1, two synthetic batches, viz on batch 0
only.  On the CPU the steps run op by op, so the marks read the host clock; the card's graphs
record them as event nodes (``tests/test_torch_port_cuda.py``).
"""
import contextlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vpho_tpu_torch.configs.config import get_config
from vpho_tpu_torch.engine import profiling as P
from vpho_tpu_torch.engine import trainer as TT
from vpho_tpu_torch.engine.graphs import CapturedStep
from vpho_tpu_torch.engine.runner import synthetic_stream
from vpho_tpu_torch.utils import marks as M

torch.set_num_threads(1)

ARGV = ["--eval_batch_size", "2", "--batch_size", "2", "--sample_num", "2",
        "--sampling_steps", "1", "--patch_size", "64", "--topk_hand", "1", "--topk_obj", "1",
        "--repeat_num", "2", "--print_freq", "1", "--num_devices", "1"]
STAGE_KEYS = [key for key, _, _ in M.STAGES]
SPAN = re.compile(r"^vpho\.([a-z0-9_.]+)(?:\[(\d+)\])?$")


def _spans(prof):
    """{(name, batch or None)} of the profiler's ``vpho.*`` ranges."""
    out = set()
    for e in prof.events():
        m = SPAN.match(e.name)
        if m:
            out.add((m.group(1), None if m.group(2) is None else int(m.group(2))))
    return out


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    cfg = get_config(["--mode", "eval", "--viz_freq", "2"] + ARGV
                     + ["--output_dir", str(tmp_path_factory.mktemp("spans"))])
    tt = TT.Trainer(cfg, device="cpu")
    tt.init_state(steps_per_epoch=2)
    return tt


@pytest.fixture(scope="module")
def profiled_eval(trainer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = trainer.evaluate(synthetic_stream(trainer.ctx, trainer.cfg, 2, 2, seed=5,
                                                with_eval_keys=True))
    return out, _spans(prof)


def test_span_is_one_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    first = P.span("x0", 3)
    assert isinstance(first, contextlib.nullcontext)
    assert P.span("testers") is first and P.span("predict_step.replay") is first
    with first:
        with P.span("x0", 4):
            pass


def test_span_is_a_profiler_range_while_one_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("x0", 7):
            with P.span("train.log"):
                torch.ones(2).sum()
    assert {("x0", 7), ("train.log", None)} <= _spans(prof)


def test_stage_mark_outside_a_recording_records_nothing():
    M.stage_mark("start")
    assert M._marking is None
    with M.marking(M.Clock("cpu")) as marks:
        M.stage_mark("start")
        with M.marking(M.Clock("cpu")) as inner:
            M.stage_mark("trunk")
        M.stage_mark("end")
    M.stage_mark("ode")
    assert set(marks) == {"start", "end"} and set(inner) == {"trunk"}
    assert M._marking is None
    assert marks["start"] <= inner["trunk"] <= marks["end"]


def test_an_eager_step_keeps_its_marks():
    """A marked step keeps its call's marks; any other step's marks do nothing (the candidate
    step runs the same ``forward_candidates`` marks and keeps none)."""
    def fn(x):
        M.stage_mark("start")
        M.stage_mark("trunk")
        y = x * 2
        M.stage_mark("ode")
        M.stage_mark("end")
        return y

    step = CapturedStep(fn, "marked", marked=True)
    assert torch.equal(step(torch.ones(3)), torch.full((3,), 2.0))
    assert set(step.marks) == {"launch", "start", "trunk", "ode", "end"}
    got = M.stage_seconds(step.marks)
    assert list(got) == STAGE_KEYS and all(v >= 0.0 for v in got.values())
    assert M.stage_seconds({"launch": 1.0, "start": 1.5}) == {"launch_wait_s": 0.5}
    plain = CapturedStep(fn, "plain")
    assert torch.equal(plain(torch.ones(3)), torch.full((3,), 2.0))
    assert plain.marks == {} and M._marking is None


def test_evaluate_emits_its_spans_per_batch(profiled_eval):
    _, spans = profiled_eval
    for i in (0, 1):
        for name in ("stage_wait", "x0", "postprocess", "testers", "rows_to_host", "timing"):
            assert (name, i) in spans, (name, i)
    assert ("viz", 0) in spans and ("viz", 1) not in spans
    assert ("predict_step.eager", None) in spans           # both batches run op by op here
    assert ("predict_step.copy_in", None) in spans         # the signature, before the eager run
    assert ("hand_metrics.eager", None) in spans
    assert not any(name in ("batch", "train.epoch") for name, _ in spans)


def test_evaluate_times_the_predict_stages(profiled_eval):
    timing = profiled_eval[0]["timing"]
    assert len(timing["predict_s"]) == 2
    for key in STAGE_KEYS:
        assert len(timing[key]) == 2 and all(v >= 0.0 for v in timing[key]), key
    for i in range(2):
        inside = timing["trunk_s"][i] + timing["ode_s"][i] + timing["aggregate_s"][i]
        assert 0.0 < inside <= timing["predict_s"][i]
        assert inside + timing["launch_wait_s"][i] <= timing["predict_s"][i]


def test_train_epoch_emits_its_spans(trainer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_one_epoch(0, synthetic_stream(trainer.ctx, trainer.cfg, 1, 2, seed=3), 1)
    spans = _spans(prof)
    assert {("stage_wait", 0), ("train.log", 0), ("train.epoch_end", 0)} <= spans
