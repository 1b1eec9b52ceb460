"""K4: the eval trunk's batch norm, residual add and activation as one pass.

Replaces no TPU kernel: the JAX package leaves batch norm to XLA.  For x (N, C, H, W) in
bfloat16 or float32, contiguous NCHW or channels-last, a BN module's running statistics and
affine parameters (float32, C) and an optional residual of x's shape, dtype and layout:

    y = round(BN(float(x))),   y = round(y + r) with a residual,   then leaky (0.01) or relu

round being round-to-nearest-even to x's dtype.  :func:`bn_act` launches the hand-written
kernel in ``csrc/bn_act.cu``, equal bit for bit on the card to the chain it replaces,
``models/layers.py::bn_act_plain`` (3-6 kernels: the cast to float32, cuDNN's inference batch
norm, the cast back, the add, the activation).  The kernel has no CPU form;
``models/layers.py::bn_act`` chooses between the two.

Bound on an H100 SXM: bytes (read x and the residual once, write y once) over 3.35 TB/s; the
trunk's 147 sites at an eval batch of 64 move ~8 GB, ~2.4 ms (``benchmark/roofline_k4.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

launches = 0
bytes_moved = 0      # the launched kernels' bytes in and out (``traffic``)

ACTS = (None, "leaky", "relu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def traffic(x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> int:
    """Bytes of one call: x in, y out, and the residual in."""
    return x.numel() * x.element_size() * (3 if residual is not None else 2)


def _layout(x: torch.Tensor) -> int:
    """0 for contiguous NCHW, 1 for contiguous channels-last (a tensor that is both is NCHW)."""
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"bn_act: x must be contiguous NCHW or channels-last, got strides "
                     f"{tuple(x.stride())} for shape {tuple(x.shape)}")


def bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor, eps: float, act: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, C, H, W) bf16 or f32 on a card; mean, var, weight, bias (C,) f32; residual like x
    or None; act None, "leaky" or "relu" -> a new tensor of x's dtype and layout."""
    global launches, bytes_moved
    if x.device.type != "cuda":
        raise ValueError(f"bn_act: the kernel runs on a card, got a tensor on {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"bn_act: x must be a 4-d bfloat16 or float32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if act not in ACTS:
        raise ValueError(f"bn_act: act must be one of {ACTS}, got {act!r}")
    if not 0 < x.numel() < 2 ** 31:
        raise ValueError(f"bn_act: {x.numel()} elements, the kernel takes 1 to 2^31 - 1")
    layout = _layout(x)
    N, C, H, W = x.shape
    for name, t in (("mean", mean), ("var", var), ("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (C,) \
                or not t.is_contiguous():
            raise ValueError(f"bn_act: {name} must be a contiguous float32 ({C},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if residual is not None:
        same = residual.is_contiguous() if layout == 0 else \
            residual.is_contiguous(memory_format=torch.channels_last)
        if residual.device != x.device or residual.dtype != x.dtype \
                or residual.shape != x.shape or not same:
            raise ValueError(f"bn_act: the residual must match x ({x.dtype}, {tuple(x.shape)}, "
                             f"strides {tuple(x.stride())}), got {residual.dtype}, "
                             f"{tuple(residual.shape)}, strides {tuple(residual.stride())}")
    y = torch.empty_like(x)
    fn = cuda_build.load("bn_act").vpho_bn_act
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    cuda_build.check(fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
                        y.data_ptr(), mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
                        bias.data_ptr(), float(eps), x.numel(), C, H * W, layout,
                        _DTYPES[x.dtype], ACTS.index(act), stream), "bn_act")
    launches += 1
    bytes_moved += traffic(x, residual)
    return y
