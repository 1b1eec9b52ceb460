"""Nothing the benchmark runs loads JAX or the JAX package (whole top-level module names), and
the reference loads nothing of the port either; each checked in a fresh interpreter."""
from __future__ import annotations

import json
import subprocess
import sys

from benchmark import harness

JAX = ("jax", "jaxlib", "flax", "optax", "orbax", "vpho_tpu")
PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for target in {targets!r}:
    importlib.import_module(target)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded_top_level(targets):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=harness.ROOT, targets=targets)],
                         capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    targets = ["benchmark.run", "benchmark.drivers.eval_loop", "benchmark.drivers.train_loop",
               "benchmark.readings", "benchmark.count_flops"]
    assert not loaded_top_level(targets) & set(JAX)


def test_harness_with_the_port_loads_no_jax():
    targets = ["benchmark.run", "vpho_tpu_torch.engine.trainer", "vpho_tpu_torch.engine.runner"]
    assert not loaded_top_level(targets) & set(JAX)


def test_reference_loads_neither_jax_nor_the_port():
    targets = ["benchmark.reference.vpho_ref.models.vpho",
               "benchmark.reference.vpho_ref.engine.metrics",
               "benchmark.reference.vpho_ref.engine.post", "benchmark.compare",
               "benchmark.traffic.generator", "benchmark.weights"]
    assert not loaded_top_level(targets) & (set(JAX) | {"vpho_tpu_torch"})
