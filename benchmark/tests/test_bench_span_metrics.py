"""The readers of the predict graph's stage spans: each is the mean of its ``evaluate`` timing
key after batch 0, in ms, under both cells' names, and reads nothing from a program that keeps
no such key."""
from __future__ import annotations

import pytest

from benchmark import harness

KEYS = {"trunk_ms": "trunk_s", "ode_ms": "ode_s", "aggregate_ms": "aggregate_s",
        "launch_wait_ms": "launch_wait_s"}
NAMES = [f"{q}.{cell}" for q in KEYS for cell in ("eval", "infer")]


def _record(**timing):
    base = {"batch_s": [3.0, 0.2, 0.2, 0.2], "predict_s": [1.0, 0.075, 0.076, 0.077]}
    return {"timing": {**base, **timing}, "frames": 192, "window_s": 0.6}


@pytest.mark.parametrize("name", NAMES)
def test_reader_is_the_mean_after_batch_0(name):
    key = KEYS[name.split(".")[0]]
    rec = _record(**{key: [9.0, 0.010, 0.020, 0.030]})
    assert harness.load_module("metrics", name).read(rec) == pytest.approx(20.0, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_its_key(name):
    reader = harness.load_module("metrics", name)
    assert reader.read(_record()) is None
    assert reader.read({"frames": 0}) is None


@pytest.mark.parametrize("name", NAMES)
def test_entry_names_the_reader_and_its_cell(name):
    entry = {m["name"]: m for m in harness.load_spec(
        "eval-dexycb-bs64" if name.endswith(".eval") else "infer-frame-bs1").per_layer}[name]
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["layer"] == "compiled predict step"
