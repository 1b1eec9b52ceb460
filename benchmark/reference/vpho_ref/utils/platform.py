"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``; when no GPU is
present and the CPU was not asked for, it raises instead of carrying on on the CPU.
``device_index`` and ``device_constant`` keep the constant tensors of the captured steps on the
device.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vpho_tpu_torch runs on CUDA by default and no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def copy_to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor copied to ``device`` without waiting for the device (pinned, non-blocking):
    constants are made at a step's first call, which on a card may be a graph's warm-up, where
    an operation that waits raises."""
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):             # a normal tensor: autograd may save it
        return copy_to_device(torch.tensor(values, dtype=dtype), device)


def device_index(values: Sequence[int], device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor on ``device``, made at its first use and kept.  Indexing a
    CUDA tensor with a Python list copies the list to the device and waits for the copy at every
    call, which a CUDA graph cannot capture; indexing with this tensor launches no copy."""
    return _constant(tuple(int(v) for v in values), torch.long, torch.device(device))


def device_constant(values: Sequence[float], device: torch.device) -> torch.Tensor:
    """A constant float32 tensor on ``device``, made at its first use and kept (as
    ``device_index``: ``torch.tensor(values, device=...)`` would copy it there at every call)."""
    return _constant(tuple(float(v) for v in values), torch.float32, torch.device(device))
