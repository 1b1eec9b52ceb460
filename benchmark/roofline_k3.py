"""The work of K3, the metrics' nearest-point kernel (``vpho_tpu_torch/csrc/metric_nn.cu``), over
an eval batch, against the H100's published peaks in ``roofline.py``: its least time is the
larger of its operations over the FP32 peak and its bytes over the memory rate, with each input
byte read once and each output byte written once."""
from __future__ import annotations

from benchmark.roofline import PEAK_BYTES, PEAK_FP32_FLOPS


def k3_flops(B: int, Vf: int = 4000, Vs: int = 2048) -> float:
    """Each of the batch's two object testers pairs every sample's Vf x Vf full-mesh points
    (F-score, Chamfer) and Vs x Vs sampled points (ADD-S): 8 operations a pair, each call's
    pairs counted once."""
    return 2.0 * B * (Vf * Vf + Vs * Vs) * 8.0


def k3_bytes(B: int, Vf: int = 4000, Vs: int = 2048) -> float:
    """Two testers' points in (f32 xyz), the full mesh's mask in (f32) and both directions'
    minima out (f32)."""
    return 2.0 * B * (12.0 * 2 * (Vf + Vs) + 4.0 * Vf + 4.0 * 2 * (Vf + Vs))


def k3_least_s(B: int, Vf: int = 4000, Vs: int = 2048) -> float:
    """An eval batch's least time for the kernel (its 4 launches) at B samples against the
    registry's Vf-point padded meshes (the synthetic registry's 4000) and Vs sampled points:
    bound by FP32 operations (~0.31 ms at B 64)."""
    return max(k3_flops(B, Vf, Vs) / PEAK_FP32_FLOPS, k3_bytes(B, Vf, Vs) / PEAK_BYTES)
