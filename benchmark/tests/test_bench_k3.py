"""The K3 roofline's reader and its arithmetic (``roofline_k3.py``) at the eval cell's shapes."""
from __future__ import annotations

import pytest

from benchmark import harness, roofline, roofline_k3


def test_k3_bound_at_the_eval_shapes():
    pairs = 2 * 64 * (4000 ** 2 + 2048 ** 2)                       # 2.58e9 a batch
    assert roofline_k3.k3_flops(64) == 8 * pairs
    assert roofline_k3.k3_bytes(64) == 2 * 64 * (12 * 2 * 6048 + 4 * 4000 + 4 * 2 * 6048)
    assert roofline_k3.k3_least_s(64) == 8 * pairs / roofline.PEAK_FP32_FLOPS
    assert roofline_k3.k3_least_s(64) * 1e3 == pytest.approx(0.3086, abs=5e-5)


def _record(kernels):
    return {"spec": harness.load_spec("eval-dexycb-bs64"),
            "trace": {"kernels": kernels, "busy_s": 0.8, "window_s": 0.9, "breakdown": {}}}


def test_k3_reader():
    read = harness.load_module("metrics", "k3_roofline_pct").read
    four_batches = {"void (anonymous namespace)::metric_nn_kernel<true>(float const*)": [0.004, 8],
                    "void (anonymous namespace)::metric_nn_kernel<false>(float const*)": [0.002, 8],
                    "min_dist_kernel(float const*)": [0.0006, 8]}
    assert read(_record(four_batches)) == pytest.approx(
        100 * 4 * roofline_k3.k3_least_s(64) / 0.006, rel=1e-12)
    assert read(_record({"min_dist_kernel(float const*)": [0.0006, 8]})) is None
    assert read(_record({"metric_nn_kernel<true>": [0.004, 7]})) is None
    assert read({"spec": None}) is None
