"""The yardstick's arithmetic: the H100's published peaks and the work of the two kernels.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the 700 W limit.  A
kernel's least time is the larger of its operations over the peak of its type and its bytes
over the memory rate, with each input byte read once and each output byte written once
(copied from ``chip_smoke.py``'s bound of each kernel, so that the kernel table's bounds and
these agree).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def k1_flops(R: int, C: int, D: int, n: int, O: int) -> float:
    """The bank-MLP's operations: both layers' multiply-adds over R rows and n banks."""
    return 2.0 * R * C * D * n + 2.0 * R * D * O * n


def k1_bytes(R: int, C: int, D: int, n: int, O: int, B: int) -> float:
    """p (R, C) bf16, W1 (n, C, D) bf16, add (B, n, D) f32, W2 (n, D, O) bf16, b2 (n, O) f32
    in; out (R, n, O) f32."""
    return 2.0 * R * C + 2.0 * n * C * D + 4.0 * B * n * D + 2.0 * n * D * O + 4.0 * n * O \
        + 4.0 * R * n * O


def k1_least_s(B: int, S: int, C: int = 256, D: int = 256, n: int = 32, O: int = 3) -> float:
    """One launch's least time at B samples of S hypotheses (R = B*S rows), bound by bf16
    operations at the blessed shapes."""
    R = B * S
    return max(k1_flops(R, C, D, n, O) / PEAK_BF16_FLOPS, k1_bytes(R, C, D, n, O, B) / PEAK_BYTES)


def k2_flops(queries: int, V: int) -> float:
    """The nearest-vertex search's operations: 8 a (query, vertex) pair."""
    return 8.0 * queries * V


def k2_bytes(queries: int, V: int, B: int) -> float:
    """Queries (queries, 3) f32 and vertices (B, V, 3) f32 in; dist f32 and idx int32 out."""
    return 12.0 * queries + 12.0 * B * V + 8.0 * queries


def k2_least_s(B: int, N: int, P: int = 32, V: int = 2048) -> float:
    """One launch's least time: B samples x N candidates x P points against V vertices each,
    bound by FP32 operations at the blessed shapes."""
    q = B * N * P
    return max(k2_flops(q, V) / PEAK_FP32_FLOPS, k2_bytes(q, V, B) / PEAK_BYTES)
