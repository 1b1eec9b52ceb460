"""Profiling and tracing helpers (counterpart of ``vpho_tpu/engine/profiling.py``).

  * ``param_count``: parameter total of a module
  * ``flops_of``: run a call under ``torch.utils.flop_counter.FlopCounterMode``; that mode sees
    aten ops only, so the operations of the hand-written kernels launched inside the call (K1,
    K2, K3: their wrappers' ``operations`` counters) are added
  * ``span(name, batch)``: ``vpho.<name>[<batch>]`` as a profiler range while a profiler
    records, so a trace shows what the port's host was doing on the device's clock; otherwise
    one shared null context, at the cost of one check.  The range is a host operation
    (``_RecordFunctionFast``), not ``record_function``'s user range: for a user range the
    profiler also lays an annotation over the device's timeline, which reads as device work
    (a union of the device's intervals would count the idle time under it as busy)
  * ``trace``: ``torch.profiler`` over a block, written as a Chrome trace into a directory

The device-clock stage marks of a step (``stage_mark``, ``Clock``) are in ``utils/marks.py``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional

import torch

from ..ops import bank_mlp as K1
from ..ops import metric_nn as K3
from ..ops import min_dist as K2


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def flops_of(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``; returns ``(output, {"flops": ..., "kernel_flops": ...})``
    where ``flops`` counts every operation and ``kernel_flops`` the hand-written kernels'."""
    from torch.utils.flop_counter import FlopCounterMode

    k0 = K1.operations + K2.operations + K3.operations
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    kernel = K1.operations + K2.operations + K3.operations - k0
    return out, {"flops": float(counter.get_total_flops()) + kernel, "kernel_flops": kernel}


_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str, batch: Optional[int] = None):
    """``vpho.<name>`` (``[batch]`` appended when given) as a profiler range while a profiler
    records, else a shared null context."""
    if not _profiler_enabled():
        return _NULL
    return torch._C._profiler._RecordFunctionFast(
        f"vpho.{name}" if batch is None else f"vpho.{name}[{batch}]")


@contextlib.contextmanager
def trace(log_dir: str = "output/trace"):
    """``torch.profiler`` trace of the block (host and, on a GPU, device activity), written
    to ``<log_dir>/trace.json`` (open in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    holder: Dict[str, Any] = {}
    with profile(activities=activities) as prof:
        yield holder
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    holder["path"] = path
    holder["profile"] = prof
