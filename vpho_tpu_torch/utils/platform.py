"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``; when no GPU is
present and the CPU was not asked for, it raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vpho_tpu_torch runs on CUDA by default and no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
