"""The K4 roofline's reader and its arithmetic (``roofline_k4.py``) at the eval cell's shapes."""
from __future__ import annotations

import pytest

from benchmark import harness, roofline, roofline_k4


def test_k4_sites_follow_the_architecture():
    sites = roofline_k4.k4_sites(256, 32)
    assert len(sites) == 147 and sum(res for _, _, res in sites) == 29   # 16 + 2 x 13 bottlenecks
    backbone, heads = sites[:95], sites[95:]
    assert sum(c * s * s for c, s, _ in backbone) * 64 == 1_421_869_056
    assert sum(c * s * s for c, s, _ in sites) * 64 == 1_650_458_624
    assert sites[0] == (64, 128, False) and (2048, 8, True) in backbone
    assert heads[:2] == [(128, 32, False), (64, 64, False)] and heads[-1] == (128, 4, False)


def test_k4_bound_at_the_eval_shapes():
    elems = sum(c * s * s * (3 if res else 2) for c, s, res in roofline_k4.k4_sites())
    assert roofline_k4.k4_bytes(64) == 64 * 2 * elems
    assert roofline_k4.k4_bytes(64, "float32") == 2 * roofline_k4.k4_bytes(64)
    assert roofline_k4.k4_least_s(64) == roofline_k4.k4_bytes(64) / roofline.PEAK_BYTES
    assert roofline_k4.k4_least_s(64) * 1e3 == pytest.approx(2.4014, abs=5e-4)
    assert roofline_k4.k4_least_s(1) * 64 == pytest.approx(roofline_k4.k4_least_s(64))


def _record(kernels):
    return {"spec": harness.load_spec("eval-dexycb-bs64"),
            "trace": {"kernels": kernels, "busy_s": 0.8, "window_s": 0.9, "breakdown": {}}}


def test_k4_reader():
    read = harness.load_module("metrics", "k4_roofline_pct").read
    name = "void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, {}>(...)"
    four_replays = {
        name.format("1, 1, 1, true"): [0.008, 116],
        name.format("0, 0, 0, false"): [0.004, 472],
        "cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, 1>(...)": [0.02, 380]}
    assert read(_record(four_replays)) == pytest.approx(
        100 * 4 * roofline_k4.k4_least_s(64) / 0.012, rel=1e-12)
    # a program without K4 (its BN in cuDNN), or a window cut between sites, reads nothing
    assert read(_record({"cudnn::bn_fw_inf_1C11_kernel_NHWC<float>": [0.02, 380]})) is None
    assert read(_record({"bn_act_kernel<float>": [0.004, 146]})) is None
    assert read({"spec": None}) is None
