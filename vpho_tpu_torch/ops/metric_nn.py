"""K3: nearest-point distances both ways for the eval metrics (ADD-S, F-score, Chamfer).

Replaces no TPU kernel: the JAX package leaves ``vpho_tpu/engine/metrics.py``'s distance
blocks to XLA.  For a (N, P, 3) and b (N, Q, 3) float32 and an optional mask (N, P == Q) of
the real points of both sets (mesh padding is skipped):

    d2 = (|a|^2 + |b|^2) - 2 a.b,   every dot product rounded as ``dot3`` rounds it
    d_ab = sqrt(min over real b of max(d2, 0)) (N, P),   d_ba = the same over real a (N, Q)

On a CUDA tensor :func:`nearest` launches the hand-written kernel in ``csrc/metric_nn.cu``,
which never builds the (P, Q) block and gives :func:`nearest_plain`'s numbers bit for bit
(see the source for the one case where the kernel's single-rounded FMA is the more faithful);
on a CPU tensor it takes :func:`nearest_plain`, the block built a few samples at a time.

Bound on an H100 SXM at an eval batch of 64 (two testers, each 64 x 4000^2 and 64 x 2048^2
pairs): 2.58e9 pairs x 8 flops at the 67 TFLOP/s FP32 peak, ~0.31 ms, against ~8 MB of
traffic: bound by operations.  The kernel keeps a block's a-points in registers and streams the
b-points through shared memory, so each pair is arithmetic on registers alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0
operations = 0       # the launched kernels' operations (``flops``), which profilers cannot see

# elements of one (chunk, P, Q) distance block of the plain form
_BLOCK_ELEMENTS = 1 << 25
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def flops(N: int, P: int, Q: int) -> float:
    """Operations of one call: 8 a (P, Q) pair (the dot product, the expansion, the minima)."""
    return 8.0 * N * P * Q


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x * y + z with one rounding (the float32 product is exact in float64)."""
    acc = z.double()
    return acc.addcmul_(x.double(), y.double()).float()


def dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_i x[..., i] y[..., i] over a last axis of 3, broadcasting, rounded as the
    reference's CPU arithmetic rounds it: the first product, then two fused multiply-adds
    (``engine/metrics.py``'s docstring says why)."""
    acc = x[..., 0] * y[..., 0]
    return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], acc))


def nearest_plain(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None,
                  chunk: int | None = None):
    """Plain version: builds the (chunk, P, Q) squared-distance block, ``chunk`` samples at a
    time to bound peak memory (the chunk changes no result).  The expanded d^2 is symmetric bit
    for bit, so one block per sample serves both directions."""
    N, P, Q = a.shape[0], a.shape[1], b.shape[1]
    chunk = chunk or max(1, _BLOCK_ELEMENTS // (P * Q))
    a2, b2 = dot3(a, a), dot3(b, b)
    d_ab, d_ba = [], []
    for s in range(0, N, chunk):
        e = slice(s, s + chunk)
        ab = dot3(a[e, :, None, :], b[e, None, :, :])
        d2 = torch.clamp_min((a2[e, :, None] + b2[e, None, :]) - 2.0 * ab, 0.0)
        if mask is None:
            d_ab.append(d2.amin(-1))
            d_ba.append(d2.amin(-2))
        else:
            m = mask[e] > 0
            d_ab.append(torch.where(m[:, None, :], d2, torch.inf).amin(-1))
            d_ba.append(torch.where(m[:, :, None], d2, torch.inf).amin(-2))
    return torch.sqrt(torch.cat(d_ab)), torch.sqrt(torch.cat(d_ba))


def nearest(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None,
            chunk: int | None = None):
    """a (N, P, 3), b (N, Q, 3) f32, mask (N, P == Q) f32 or None -> (d_ab (N, P), d_ba (N, Q))
    f32.  ``chunk`` bounds the plain form's block on the CPU; the kernel builds none."""
    global launches, operations
    if a.device.type == "cpu":
        return nearest_plain(a, b, mask, chunk)
    if a.dim() != 3 or a.shape[-1] != 3 or b.dim() != 3 or b.shape[-1] != 3 \
            or b.shape[0] != a.shape[0] or not 0 < a.shape[0] <= 65535:
        raise ValueError(f"metric_nn: bad shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if mask is not None and (tuple(mask.shape) != tuple(a.shape[:2]) or a.shape[1] != b.shape[1]):
        raise ValueError(f"metric_nn: mask {tuple(mask.shape)} must be (N, P == Q) for "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    named = (("a", a), ("b", b)) + ((("mask", mask),) if mask is not None else ())
    for name, t in named:
        if t.device != a.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"metric_nn: {name} must be a contiguous float32 tensor "
                             f"on {a.device}, got {t.dtype} on {t.device}")
    N, P, Q = a.shape[0], a.shape[1], b.shape[1]
    # the kernel merges squared minima with atomicMin on their bits, from +inf
    d_ab = torch.full((N, P), torch.inf, device=a.device, dtype=torch.float32)
    d_ba = torch.full((N, Q), torch.inf, device=a.device, dtype=torch.float32)
    fn = cuda_build.load("metric_nn").vpho_metric_nn
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    cuda_build.check(fn(a.data_ptr(), b.data_ptr(), None if mask is None else mask.data_ptr(),
                        d_ab.data_ptr(), d_ba.data_ptr(), N, P, Q, stream), "metric_nn")
    launches += 1
    operations += flops(N, P, Q)
    return d_ab.sqrt_(), d_ba.sqrt_()
