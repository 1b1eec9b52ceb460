"""The control's precision switch: the bf16 policy's roundings, or one step below them.

Every cast of the bf16 policy goes through ``to_compute``.  With ``low(True)`` a bfloat16
operand is further rounded to float8 e4m3 with a per-tensor scale (its largest magnitude at
e4m3's 448), the next precision below bfloat16; with ``low(False)`` (the default) it is the
plain cast.
"""
from __future__ import annotations

import contextlib

import torch

_LOW = [False]
_E4M3_MAX = 448.0


@contextlib.contextmanager
def low(on: bool = True):
    """Within the block, bf16 operands are rounded to scaled float8 e4m3."""
    before = _LOW[0]
    _LOW[0] = on
    try:
        yield
    finally:
        _LOW[0] = before


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, returned in ``x``'s dtype."""
    x32 = x.float()
    scale = x32.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return ((x32 / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def to_compute(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x.to(dtype)``, and under ``low`` a bfloat16 result rounded to scaled float8."""
    y = x.to(dtype)
    if _LOW[0] and dtype == torch.bfloat16 and y.is_floating_point():
        y = fp8_round(y)
    return y
