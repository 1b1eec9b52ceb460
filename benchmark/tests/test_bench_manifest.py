"""BENCHMARK.json resolves, by name, to the files the harness reads, and keeps the contract's
shape; the configurations' model settings are the port's flags."""
from __future__ import annotations

import dataclasses
import json
import os
import re

import pytest

from benchmark import harness

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    spec = harness.load_spec(workload)
    assert spec.entry["chips"] == 1
    driver = harness.load_module("drivers", spec.cell["driver"])
    for fn in ("setup", "window", "trace", "attempted_failed", "release", "check"):
        assert callable(getattr(driver, fn))
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer, "every cell reports a per-layer metric"
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in spec.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric {workload} does not report"
    assert spec.cell["limits"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_model_is_the_ports_flags(entry):
    from vpho_tpu_torch.configs.config import get_config

    from benchmark.reference.vpho_ref.models import vpho as RV

    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        config = json.load(f)
    assert config["reduced"] == entry["reduced"] == []
    port = dataclasses.asdict(get_config(config["flags"]).to_model_config())
    ref = dataclasses.asdict(RV.ModelConfig(**config["model"]))
    assert port == ref
