"""Profiling and tracing helpers (counterpart of ``vpho_tpu/engine/profiling.py``).

  * ``param_count``: parameter total of a module
  * ``flops_of``: run a call under ``torch.utils.flop_counter.FlopCounterMode``; that mode sees
    aten ops only, so the operations of the hand-written kernels launched inside the call (K1,
    K2: their wrappers' ``operations`` counters) are added
  * ``device_timer``: wall time fenced by ``torch.cuda.synchronize``
  * ``trace``: ``torch.profiler`` over a block, written as a Chrome trace into a directory
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch

from ..ops import bank_mlp as K1
from ..ops import min_dist as K2


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def flops_of(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``; returns ``(output, {"flops": ..., "kernel_flops": ...})``
    where ``flops`` counts every operation and ``kernel_flops`` the hand-written kernels'."""
    from torch.utils.flop_counter import FlopCounterMode

    k0 = K1.operations + K2.operations
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    kernel = K1.operations + K2.operations - k0
    return out, {"flops": float(counter.get_total_flops()) + kernel, "kernel_flops": kernel}


def _sync(device=None):
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(name: str = "", result: dict | None = None, device=None):
    """Wall time of the block, the device's queued work included."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if result is not None:
        result[name or "elapsed"] = dt
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms")


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
