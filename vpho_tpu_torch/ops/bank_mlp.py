"""K1: the fused bank-MLP of the hand denoiser's ODE fast path.

Replaces the TPU kernel ``vpho_tpu/ops/pallas_bank.py::_pallas_bank_mlp`` (body ``_kernel``,
entry ``fused_bank_mlp``).  For R = B*S hypothesis rows (sample-major) and n banks:

    out[r, k, :] = bf16(relu(p[r] @ W1[k] + add[b(r), k])) @ W2[k] + b2[k]      (f32 sums)

On a CUDA tensor :func:`bank_mlp` launches the hand-written kernel in ``csrc/bank_mlp.cu``;
on a CPU tensor it takes :func:`bank_mlp_plain`, the same arithmetic as einsums.

Bound on an H100 SXM at the blessed shapes (R 6400, C 256, D 256, n 32, O 3): ~27 GFLOP per
launch at the 989 TFLOP/s bf16 tensor-core peak, ~27 us, against ~12 MB of traffic (~4 us):
bound by operations.  The kernel runs layer 1 on the tensor cores (wmma) with each warp's W1
fragments held in registers across all rows of its samples, and keeps the hidden tile in
shared memory, so the (R, n, D) hidden tensor never reaches device memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def bank_mlp_plain(pose_feat: torch.Tensor, w1_pose: torch.Tensor, add: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version: bf16-rounded operands, f32 einsums, h rounded to bf16 after the relu."""
    B, n, D = add.shape
    p = pose_feat.to(torch.bfloat16).float()
    w1 = w1_pose.to(torch.bfloat16).float()
    h = torch.einsum("rc,ncd->rnd", p, w1).reshape(B, S, n, D) + add.float()[:, None]
    h = torch.relu(h).to(torch.bfloat16).float().reshape(B * S, n, D)
    out = torch.einsum("rnd,ndo->rno", h, w2.to(torch.bfloat16).float())
    return out + b2.float()


def bank_mlp(pose_feat: torch.Tensor, w1_pose: torch.Tensor, add: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, S: int) -> torch.Tensor:
    """pose_feat (B*S, C) bf16; w1_pose (n, C, D) bf16; add (B, n, D) f32; w2 (n, D, O)
    bf16; b2 (n, O) f32 -> (B*S, n, O) f32."""
    global launches
    if pose_feat.device.type == "cpu":
        return bank_mlp_plain(pose_feat, w1_pose, add, w2, b2, S)
    B, n, D = add.shape
    R, C = pose_feat.shape
    O = w2.shape[-1]
    expect = {
        "pose_feat": (pose_feat, (B * S, C), torch.bfloat16),
        "w1_pose": (w1_pose, (n, C, D), torch.bfloat16),
        "add": (add, (B, n, D), torch.float32),
        "w2": (w2, (n, D, O), torch.bfloat16),
        "b2": (b2, (n, O), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != pose_feat.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"bank_mlp: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {pose_feat.device}")
        if not t.is_contiguous():
            raise ValueError(f"bank_mlp: {name} must be contiguous")
    if C != 256 or D != 256 or not 1 <= O <= 4:
        raise ValueError(f"bank_mlp: the kernel takes C = D = 256 (the hand head) and O <= 4, "
                         f"got {C}, {D}, {O}")
    out = torch.empty((R, n, O), device=pose_feat.device, dtype=torch.float32)
    fn = cuda_build.load("bank_mlp").vpho_bank_mlp
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(pose_feat.device).cuda_stream
    cuda_build.check(fn(pose_feat.data_ptr(), w1_pose.data_ptr(), add.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                        B, S, C, D, O, n, stream), "bank_mlp")
    launches += 1
    return out
