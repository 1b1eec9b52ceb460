"""K1: the fused bank-MLP of the hand denoiser's ODE fast path.

Replaces the TPU kernel ``vpho_tpu/ops/pallas_bank.py::_pallas_bank_mlp`` (body ``_kernel``,
entry ``fused_bank_mlp``).  For R = B*S hypothesis rows (sample-major) and n banks:

    out[r, k, :] = bf16(relu(p[r] @ W1[k] + add[b(r), k])) @ W2[k] + b2[k]      (f32 sums)

The constant operands are prepared once (:func:`prepare`: W1 transposed to K-major, W2 padded
to 8 columns in wgmma's core-matrix order, b2 in f32) and the per-step call
:func:`bank_mlp_prepared` takes only ``p`` and ``add`` anew.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/bank_mlp.cu``; on a CPU tensor it takes the plain version, the
same arithmetic as einsums.  :func:`bank_mlp` is prepare-and-launch in one call.

Bound on an H100 SXM at the blessed shapes (R 6400, C 256, D 256, n 32, O 3): ~27 GFLOP per
launch at the 989 TFLOP/s bf16 tensor-core peak, ~27.5 us, against ~12 MB of traffic (~4 us):
bound by operations.  The kernel runs both layers as wgmma: layer 1 from a TMA-fed ring of p
tiles against W1[k] resident in shared memory, layer 2 from the bf16 hidden tile in registers,
so the (R, n, D) hidden tensor never reaches device memory.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build

launches = 0
operations = 0       # the launched kernels' operations (``flops``), which profilers cannot see


def flops(R: int, C: int, D: int, n: int, O: int) -> float:
    """Operations of one call: both layers' multiply-adds."""
    return 2.0 * R * C * D * n + 2.0 * R * D * O * n

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_N2 = 8          # layer 2's wgmma width: W2 is zero-padded to 8 columns


class BankWeights(NamedTuple):
    """The kernel's constant operands, in its layouts."""

    w1t: torch.Tensor     # (n, D, C) bf16: W1's pose slice, K-major
    w2p: torch.Tensor     # (n, D/8, 8, 8) bf16: W2 padded to 8 columns, [k-block, o, k] order
    b2: torch.Tensor      # (n, O) f32


def prepare(w1_pose: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> BankWeights:
    """w1_pose (n, C, D), w2 (n, D, O), b2 (n, O) in any float type -> :class:`BankWeights`."""
    n, D, O = w2.shape
    bf = torch.bfloat16
    w2pad = torch.zeros((n, D, _N2), dtype=bf, device=w2.device)
    w2pad[..., :O] = w2.to(bf)
    w2p = w2pad.reshape(n, D // 8, 8, _N2).transpose(2, 3).contiguous()
    return BankWeights(w1_pose.to(bf).transpose(1, 2).contiguous(), w2p,
                       b2.float().contiguous())


def unprepare(w: BankWeights):
    """The plain layouts back: (w1_pose (n, C, D), w2 (n, D, O)) in bf16, bit for bit."""
    n, D = w.w1t.shape[:2]
    w2 = w.w2p.transpose(2, 3).reshape(n, D, _N2)[..., :w.b2.shape[1]]
    return w.w1t.transpose(1, 2), w2


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


def bank_mlp_prepared_plain(pose_feat: torch.Tensor, w: BankWeights, add: torch.Tensor,
                            S: int) -> torch.Tensor:
    """:func:`bank_mlp_plain` on prepared operands."""
    w1_pose, w2 = unprepare(w)
    return bank_mlp_plain(pose_feat, w1_pose, add, w2, w.b2, S)


def bank_mlp_prepared(pose_feat: torch.Tensor, w: BankWeights, add: torch.Tensor,
                      S: int) -> torch.Tensor:
    """pose_feat (B*S, C) bf16; add (B, n, D) f32; w from :func:`prepare` -> (B*S, n, O) f32."""
    global launches, operations
    if pose_feat.device.type == "cpu":
        return bank_mlp_prepared_plain(pose_feat, w, add, S)
    B, n, D = add.shape
    R, C = pose_feat.shape
    O = w.b2.shape[1]
    expect = {
        "pose_feat": (pose_feat, (B * S, C), torch.bfloat16),
        "w1t": (w.w1t, (n, D, C), torch.bfloat16),
        "add": (add, (B, n, D), torch.float32),
        "w2p": (w.w2p, (n, D // 8, _N2, 8), torch.bfloat16),
        "b2": (w.b2, (n, O), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != pose_feat.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"bank_mlp: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {pose_feat.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bank_mlp: {name} must be contiguous and 16-byte aligned (TMA)")
    if C != 256 or D != 256 or not 1 <= O <= 4:
        raise ValueError(f"bank_mlp: the kernel takes C = D = 256 (the hand head) and O <= 4, "
                         f"got {C}, {D}, {O}")
    out = torch.empty((R, n, O), device=pose_feat.device, dtype=torch.float32)
    fn = cuda_build.load("bank_mlp").vpho_bank_mlp
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(pose_feat.device).cuda_stream
    cuda_build.check(fn(pose_feat.data_ptr(), w.w1t.data_ptr(), add.data_ptr(),
                        w.w2p.data_ptr(), w.b2.data_ptr(), out.data_ptr(),
                        R, S, C, D, O, n, stream), "bank_mlp")
    launches += 1
    operations += flops(R, C, D, n, O)
    return out


def bank_mlp(pose_feat: torch.Tensor, w1_pose: torch.Tensor, add: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, S: int) -> torch.Tensor:
    """pose_feat (B*S, C) bf16; w1_pose (n, C, D) bf16; add (B, n, D) f32; w2 (n, D, O)
    bf16; b2 (n, O) f32 -> (B*S, n, O) f32: :func:`prepare`, then :func:`bank_mlp_prepared`."""
    if pose_feat.device.type == "cpu":
        return bank_mlp_plain(pose_feat, w1_pose, add, w2, b2, S)
    return bank_mlp_prepared(pose_feat, prepare(w1_pose, w2, b2), add, S)
