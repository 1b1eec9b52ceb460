"""Cells at a size the CPU tests can hold: the real cells' files, with the shapes cut (patch 64,
2 hypotheses, 2 ODE steps, top 1, batches of 2)."""
from __future__ import annotations

import copy

from benchmark import harness

TINY_EVAL = {"--patch_size": "64", "--sample_num": "2", "--sampling_steps": "2",
             "--topk_hand": "1", "--topk_obj": "1"}
TINY_MODEL = {"patch_size": 64, "sample_num": 2, "sampling_steps": 2, "topk_hand": 1,
              "topk_obj": 1}


def _flags(flags, changes):
    flags = list(flags)
    for k, v in changes.items():
        if k in flags:
            flags[flags.index(k) + 1] = v
        else:
            flags += [k, v]
    return flags


def tiny_spec(workload: str, pool: int = 2, batch_size: int = 2) -> harness.Spec:
    spec = copy.deepcopy(harness.load_spec(workload))
    model = spec.config["model"]
    changes = {k: v for k, v in TINY_EVAL.items() if k in spec.config["flags"]}
    spec.config["flags"] = _flags(spec.config["flags"], changes)
    model.update({k: v for k, v in TINY_MODEL.items() if k in model})
    spec.mix.update(patch_size=64, pool=pool, batch_size=batch_size, traced_batches=1,
                    traced_steps=1)
    if "check_sample" in spec.mix:
        spec.mix["check_sample"] = 1
    return spec
