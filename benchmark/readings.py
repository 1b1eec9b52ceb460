#!/usr/bin/env python3
"""Readings that set a cell's limits: the control and the planted faults, each in the
program's place, against the reference, at the cell's own size.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --as control

``--as``: ``control`` (the reference one precision below the configuration's: scaled float8
operands for the bf16 eval, the bf16 policy for the float32 training step); for the training
cell, ``half_batch`` (each step's loss a mean over the first half of its batch); for an eval
cell, ``x0_ulp`` (the reference with each ODE start value moved by one float32 ulp: a change
of the size of a rounding, so its gaps are what the model's own sensitivity gives at that
seed, with no program in the comparison).  A
state left unchanged reads 1 by the training measure and needs no run.  The eval cells' faults
are planted in the program by ``benchmark/tests/test_bench_faults.py``.  Each seed prints one
JSON line of the compared numbers beside the cell's limits.  The benchmark's own runs never run
these.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, harness  # noqa: E402
from benchmark.drivers import eval_loop, train_loop  # noqa: E402


def control_rows(answers, batch_size: int) -> list:
    """Answers as the eval loop's dump rows, each pool frame once."""
    return [{"index": np.arange(k * batch_size, (k + 1) * batch_size),
             "pd_hand_joint": a["joint"].numpy(), "pd_obj_rt": a["obj_rt"].numpy()}
            for k, a in answers.items()]


def eval_reading(spec, seed: int, device, kind: str) -> dict:
    if kind not in ("control", "x0_ulp"):
        raise ValueError(f"an eval cell reads the control or x0_ulp, not {kind!r}")
    data = eval_loop.inputs(spec, seed, device)
    ref, ctx = eval_loop.reference_answers(spec, seed, data, device)
    if kind == "control":
        sub, _ = eval_loop.reference_answers(spec, seed, data, device, low=True)
    else:
        moved = [x.nextafter(torch.full_like(x, float("inf"))) for x in data.x0]
        sub, _ = eval_loop.reference_answers(spec, seed, SimpleNamespace(**{**vars(data),
                                                                            "x0": moved}), device)
    bs = spec.mix["batch_size"]
    obj_ids = {k: np.asarray(b["obj_id"]) for k, b in enumerate(data.pool)}
    excluded = eval_loop.excluded_class(ctx.registry)
    report = None
    if spec.mix.get("check_report"):
        frames = [(k, r) for k in sorted(sub) for r in range(bs)]
        report = compare.expected_report({k: v["rows"] for k, v in sub.items()}, frames,
                                         obj_ids, excluded)
    return compare.eval_numbers(control_rows(sub, bs), report, ref, bs, excluded,
                                obj_ids)


def train_reading(spec, seed: int, device, kind: str) -> dict:
    data = train_loop.inputs(spec, seed, device)
    ref = train_loop.reference_steps(spec, data, device)
    if kind == "control":
        sub = train_loop.reference_steps(spec, data, device, compute_dtype="bfloat16")
    elif kind == "half_batch":
        sub = train_loop.reference_steps(spec, data, device, half_batch=True)
    else:
        raise ValueError(kind)
    prog = {"losses": sub["losses"], "grad1": sub["grad1"],
            "change": compare.change_norms(sub["state"], data.sd)}
    return compare.train_numbers(prog, ref, data.sd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--as", dest="kind", required=True, choices=("control", "half_batch", "x0_ulp"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.load_spec(args.workload)
    device = torch.device(args.device)
    reading = train_reading if spec.cell["driver"] == "train_loop" else eval_reading
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = reading(spec, seed, device, args.kind)
        limits = spec.cell["limits"]
        print(json.dumps({"workload": args.workload, "as": args.kind, "seed": seed,
                          "numbers": numbers,
                          "fails": [n for n in limits if not numbers[n] <= limits[n]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
