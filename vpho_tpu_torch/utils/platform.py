"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``; when no GPU is
present and the CPU was not asked for, it raises instead of carrying on on the CPU.
``device_index`` keeps the constant index tensors of the predict path on the device.
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


@functools.lru_cache(maxsize=None)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):             # a normal tensor: autograd may save it
        return torch.tensor(values, dtype=torch.long, device=device)


def device_index(values: Sequence[int], device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor on ``device``, made at its first use and kept.  Indexing a
    CUDA tensor with a Python list copies the list to the device and waits for the copy at every
    call, which a CUDA graph cannot capture; indexing with this tensor launches no copy."""
    return _index(tuple(int(v) for v in values), torch.device(device))
