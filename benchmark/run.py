#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port (``vpho_tpu_torch``) on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It resolves the cell by name (``BENCHMARK.json`` and the files
it names under ``benchmark/``), builds the inputs and weights from ``--seed``, sets up and warms
the program, measures for ``--seconds``, checks what the timed path produced against the plain
reference (``benchmark/reference/``), and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``.
The compared numbers with their limits close both standard error and that line.

It exits non-zero and prints no result without enough CUDA cards, or when a module of JAX or
of the JAX package ``vpho_tpu`` is loaded once the window has closed.  Caches (Triton's,
torch's extensions, CUDA's kernel cache) stay in ``benchmark/.cache/`` inside the checkout.
The host's thread counts are left at their defaults, as users run the program.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vpho_tpu")


def set_env() -> None:
    """Every build and kernel cache at a fixed directory inside the checkout; no JAX for
    libraries that look."""
    cache = os.path.join(BENCH, ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ.update(USE_FLAX="0", USE_JAX="0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_description() -> dict:
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    limit = out.stdout.strip().splitlines()[0].split(",")[-1].strip() if out.returncode == 0 \
        else "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "power_limit": limit}


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set up, measure, read the metrics and check; returns the result's fields and the
    compared numbers (``checks``: name -> [value, limit])."""
    import torch

    from benchmark import harness, tracing

    driver = harness.load_module("drivers", spec.cell["driver"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(spec, seed, device)
    record = driver.window(state, seconds)
    record["setup_s"] = record["t_open"] - t_start
    record["spec"] = spec
    if trace:
        tracer = tracing.Traced()
        driver.trace(state, tracer)
        record["trace"] = tracer.table()
    attempted, failed = driver.attempted_failed(state)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release(state)
    numbers = driver.check(state)

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = harness.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = spec.cell["limits"]
    checks = {n: [numbers[n], limits[n]] for n in limits}
    correct = all(finite(v) and v <= lim for v, lim in checks.values()) and failed == 0 \
        and attempted > 0
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=record["trace"]["busy_s"],
                                window_s=record["trace"]["window_s"])
        result["breakdown"] = record["trace"]["breakdown"]
    return {"result": result, "checks": checks, "numbers": numbers, "record": record,
            "phases": state.phases, "window_stats": state.window_stats}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_env()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    spec = harness.load_spec(args.workload)
    chips = int(spec.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                   T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    result, checks = out["result"], out["checks"]
    result["device"].update(card_description())
    result["device"]["count"] = chips
    detail = {k: v for k, v in out["numbers"].items() if k not in checks}
    print(json.dumps({"setup_phases_s": out["phases"], "window": out["window_stats"],
                      "numbers_seen": detail}), file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
