"""K2: fused nearest-vertex search for the aggregation's physics rankers.

Replaces the TPU kernel ``vpho_tpu/ops/pallas_dist.py::_pallas_min_dist_idx`` (body
``_kernel``, entry ``min_dist_and_idx``).  For query points fp (B, N, P, 3) and per-sample
vertices verts (B, V, 3):

    d2 = (|x|^2 + |y|^2) - 2 x.y,   dist = sqrt(max(min_v d2, 0)),   idx = first argmin

On a CUDA tensor :func:`min_dist_and_idx` launches the hand-written kernel in
``csrc/min_dist.cu``; on a CPU tensor it takes :func:`min_dist_plain`, the (B, N, P, V) form.

Bound on an H100 SXM at the blessed stage-4 shapes (B 64, N 100, P 32, V 2048): 4.2e8 pairs
x 8 flops at the 67 TFLOP/s FP32 peak, ~50 us, against ~6 MB of traffic: bound by operations.
The kernel keeps each sample's vertices in shared memory as (-2y, |y|^2) and scans them in index
order with four queries a thread, three FP32 FMA per pair, so the (B, N, P, V) tensor is never
built and the argmin keeps the first minimum.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def min_dist_plain(fp: torch.Tensor, verts: torch.Tensor):
    """Plain version: materializes the (B, N, P, V) squared-distance tensor."""
    fp, verts = fp.float(), verts.float()
    x2 = (fp * fp).sum(-1)                                        # (B, N, P)
    y2 = (verts * verts).sum(-1)                                  # (B, V)
    xy = torch.einsum("bnkd,bvd->bnkv", fp, verts)
    d2 = x2[..., None] + y2[:, None, None] - 2.0 * xy
    dist = torch.sqrt(torch.clamp_min(d2.min(-1).values, 0.0))
    return dist, torch.argmin(d2, dim=-1).to(torch.int32)


def min_dist_and_idx(fp: torch.Tensor, verts: torch.Tensor):
    """fp (B, N, P, 3) f32; verts (B, V, 3) f32 -> dist (B, N, P) f32, idx (B, N, P) int32."""
    global launches
    if fp.device.type == "cpu":
        return min_dist_plain(fp, verts)
    if fp.dim() != 4 or fp.shape[-1] != 3 or verts.dim() != 3 or verts.shape[-1] != 3 \
            or verts.shape[0] != fp.shape[0]:
        raise ValueError(f"min_dist_and_idx: bad shapes {tuple(fp.shape)}, {tuple(verts.shape)}")
    for name, t in (("fp", fp), ("verts", verts)):
        if t.device != fp.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"min_dist_and_idx: {name} must be a contiguous float32 tensor "
                             f"on {fp.device}, got {t.dtype} on {t.device}")
    B, N, P, _ = fp.shape
    V = verts.shape[1]
    dist = torch.empty((B, N, P), device=fp.device, dtype=torch.float32)
    idx = torch.empty((B, N, P), device=fp.device, dtype=torch.int32)
    fn = cuda_build.load("min_dist").vpho_min_dist
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(fp.device).cuda_stream
    cuda_build.check(fn(fp.data_ptr(), verts.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                        B, N * P, V, stream), "min_dist")
    launches += 1
    return dist, idx
