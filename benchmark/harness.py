"""What every driver shares: the run's specification (resolved by name from
``BENCHMARK.json`` and the files it names), the program's trainer built to the configuration,
and the small statistics of the records.

A run's files: ``configs/<config>.json`` (the port's flags, the reference's model settings,
the work counts), ``traffic/mixes/<traffic>.json`` (the mix's sizes), ``workloads/<cell>.json``
(the loop module and the limits of the compared numbers), ``drivers/<loop>.py`` and
``metrics/<metric>.py``.  A new cell, configuration or metric is new files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


@dataclasses.dataclass
class Spec:
    """One cell, resolved: its entry, its configuration's, its mix and its own file."""

    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    mix: Dict[str, Any]
    cell: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(workload: str) -> Spec:
    """The cell ``workload`` of the checkout's ``BENCHMARK.json`` with its files."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(entries))})")
    entry = entries[workload]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return Spec(
        name=workload, entry=entry,
        config=_json(os.path.join(ROOT, config["file"])),
        mix=_json(os.path.join(BENCH, "traffic", "mixes", f"{entry['traffic']}.json")),
        cell=_json(os.path.join(BENCH, "workloads", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` (a driver or a metric's reader), loaded by file name: a
    metric's name may hold dots.  Without that file, ``<kind>/<name up to its first dot>.py``:
    one reader serves ``predict_ms.eval`` and ``predict_ms.infer``."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH, kind, f"{name.split('.')[0]}.py")
    stem = os.path.basename(path)[:-3]
    mod_name = f"benchmark.{kind}.{stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def out_dir(workload: str) -> str:
    """The run's output directory inside the checkout (the trainer's log directories)."""
    path = os.path.join(BENCH, ".out", workload)
    os.makedirs(path, exist_ok=True)
    return path


def make_trainer(spec: Spec, device, extra: List[str], steps_per_epoch: Optional[int] = None):
    """The port's ``Trainer`` for the configuration's flags plus ``extra``, its state
    initialised (its own seeded weights, which the cell's loop then overwrites)."""
    from vpho_tpu_torch.configs.config import get_config
    from vpho_tpu_torch.engine.trainer import Trainer

    cfg = get_config(list(spec.config["flags"]) + list(extra)
                     + ["--output_dir", out_dir(spec.name)])
    trainer = Trainer(cfg, device=device)
    trainer.init_state(steps_per_epoch)
    return trainer


def mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * sum(values) / len(values) if values else None
