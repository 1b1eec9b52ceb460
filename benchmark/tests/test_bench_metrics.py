"""Each metric reader on a recorded sample, and the yardstick's kernel bounds at the blessed
shapes (the kernel table's 0.0275, 0.0501 and 0.0155 ms)."""
from __future__ import annotations

import pytest

from benchmark import harness, roofline


def test_kernel_bounds_at_the_blessed_shapes():
    assert roofline.k1_least_s(64, 100) * 1e3 == pytest.approx(0.0275, abs=5e-5)
    assert roofline.k2_least_s(64, 100) * 1e3 == pytest.approx(0.0501, abs=5e-5)
    assert roofline.k2_least_s(64, 31) * 1e3 == pytest.approx(0.0155, abs=5e-5)


def _eval_record(workload):
    spec = harness.load_spec(workload)
    timing = {"batch_s": [3.0] + [0.2] * 29 + [0.4], "frames": [64] * 31,
              "predict_s": [1.0] + [0.073] * 30, "metrics_s": [1.0] + [0.145] * 30,
              "wait_s": [0.5] + [0.001] * 30, "preprocess_s": [0.0] * 31}
    trace = {"kernels": {"void bank_mlp_kernel(CUtensorMap)": [4 * 50 * 0.0000505, 200],
                         "min_dist_kernel(float const*)": [4 * (0.111 + 0.039) * 1e-3, 8],
                         "elementwise": [0.5, 1000]},
             "busy_s": 0.82, "window_s": 0.9, "breakdown": {}}
    return {"spec": spec, "timing": timing, "frames": 64 * 30, "window_s": 6.2,
            "setup_s": 42.0, "trace": trace, "t_open": 0.0}


READS = {
    "setup_s": 42.0,
    "eval_frames_per_s": 64 * 30 / 6.2,
    "metrics_ms.eval": 145.0,
    "predict_ms.eval": 73.0,
    "loader_wait_ms.eval": 1.0,
    "device_idle_pct.eval": 100 * (1 - 0.82 / 0.9),
    "k1_roofline_pct": 100 * roofline.k1_least_s(64, 100) / 0.0000505,
    "k2_roofline_pct": 100 * (roofline.k2_least_s(64, 100) + roofline.k2_least_s(64, 31))
    / 0.150e-3,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_eval_readers(name):
    assert harness.load_module("metrics", name).read(_eval_record("eval-dexycb-bs64")) \
        == pytest.approx(READS[name], rel=1e-9)


def test_mfu_eval_reads_the_configuration_count():
    rec = _eval_record("eval-dexycb-bs64")
    rec["spec"].config["flops"]["predict_per_frame"] = 60e9
    got = harness.load_module("metrics", "mfu_pct.eval").read(rec)
    assert got == pytest.approx(100 * 60e9 * 64 * 30 / 6.2 / roofline.PEAK_BF16_FLOPS)
    rec["spec"].config["flops"]["predict_per_frame"] = None
    assert harness.load_module("metrics", "mfu_pct.eval").read(rec) is None


def test_latency_p95_and_infer_readers():
    rec = _eval_record("infer-frame-bs1")
    rec["timing"]["batch_s"] = [5.0] + [0.040 + 0.001 * (i % 20) for i in range(400)]
    p95 = harness.load_module("metrics", "infer_latency_p95_ms").read(rec)
    assert 0.058 * 1e3 <= p95 <= 0.059 * 1e3
    assert harness.load_module("metrics", "predict_ms.infer").read(rec) == pytest.approx(73.0)
    assert harness.load_module("metrics", "frame_ms_p50.infer").read(rec) == pytest.approx(49.5)
    rec["timing"]["batch_s"] = [1.0] * 10
    assert harness.load_module("metrics", "infer_latency_p95_ms").read(rec) is None


def test_train_readers():
    spec = harness.load_spec("train-dexycb-bs64")
    spec.config["flops"]["train_per_frame"] = 1.1e11
    rec = {"spec": spec, "setup_s": 40.0, "t_open": 0.0,
           "train": {"seconds": 10.0, "steps": 76, "step_s": [0.13] * 76, "wait_s": [0.0] * 76},
           "trace": {"kernels": {}, "busy_s": 0.95, "window_s": 1.0, "breakdown": {}}}
    read = lambda n: harness.load_module("metrics", n).read(rec)
    assert read("train_frames_per_s") == pytest.approx(64 * 76 / 10.0)
    assert read("train_step_ms") == pytest.approx(130.0)
    assert read("device_idle_pct.train") == pytest.approx(5.0)
    assert read("mfu_pct.train") == pytest.approx(100 * 1.1e11 * 64 * 76 / 10.0 / 495e12)
    assert read("eval_frames_per_s") is None and read("k1_roofline_pct") is None


def test_kernel_readers_find_nothing_without_their_kernels():
    rec = _eval_record("eval-dexycb-bs64")
    rec["trace"]["kernels"] = {"elementwise": [0.5, 1000]}
    assert harness.load_module("metrics", "k1_roofline_pct").read(rec) is None
    assert harness.load_module("metrics", "k2_roofline_pct").read(rec) is None
