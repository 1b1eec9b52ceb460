"""The work of K4, the trunk's fused batch norm (``vpho_tpu_torch/csrc/bn_act.cu``), over one
predict replay, against the H100's memory rate in ``roofline.py``: a site's least time is its
bytes (x in, y out, the residual in where the site adds one) over ``PEAK_BYTES``, each byte
moved once; the ~6 operations an element are far below any compute peak.

The sites are enumerated from the architecture (``VPHONet``: two ResNet-50 FPN streams sharing
the stem, layer1 and layer4, two heatmap heads and two encoders), not read from the program."""
from __future__ import annotations

from typing import List, Tuple

from benchmark.roofline import PEAK_BYTES

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _bottleneck_layer(sites, inplanes: int, planes: int, blocks: int, stride: int, hw: int):
    """A ResNet layer of ``blocks`` bottlenecks at input side ``hw``: each block's bn1 (at its
    input side), bn2 and bn3 (with the residual) after the stride, the first block's
    downsample BN; returns the output side."""
    out = hw // stride
    for i in range(blocks):
        sites += [(planes, hw if i == 0 else out, False), (planes, out, False),
                  (planes * 4, out, True)]
        if i == 0:
            sites.append((planes * 4, out, False))
    return out


def k4_sites(patch: int = 256, roi: int = 32) -> List[Tuple[int, int, bool]]:
    """Every BN site of one trunk pass per sample as (channels, side, adds a residual): 95 in
    the backbone (the stem, layer1, layer2 and layer3 once per stream, the shared layer4 on
    both streams), 52 in the heads (each heatmap head's 2, each encoder's 8 residual blocks of
    3, the blocks in pairs at sides roi, roi/2, roi/4, roi/8)."""
    sites = [(64, patch // 2, False)]                                   # the stem
    hw = _bottleneck_layer(sites, 64, 64, 3, 1, patch // 4)             # layer1
    for _ in range(2):                                                  # two streams
        h3 = _bottleneck_layer(sites, 256, 128, 4, 2, hw)
        h4 = _bottleneck_layer(sites, 512, 256, 6, 2, h3)
        _bottleneck_layer(sites, 1024, 512, 3, 2, h4)
    for _ in range(2):                                                  # hand, object
        sites += [(128, roi, False), (64, 2 * roi, False)]              # heatmap head
        for i in range(8):                                              # encoder
            side = roi >> (i // 2)
            sites += [(256, side, False), (128, side, False), (128, side, False)]
    return sites


def k4_bytes(B: int, dtype: str = "bfloat16", patch: int = 256, roi: int = 32) -> float:
    """One replay's bytes over all sites at B samples."""
    size = DTYPE_BYTES[dtype]
    return float(sum(B * c * s * s * size * (3 if res else 2)
                     for c, s, res in k4_sites(patch, roi)))


def k4_least_s(B: int, dtype: str = "bfloat16", patch: int = 256, roi: int = 32) -> float:
    """One replay's least time for K4's launches (~2.4 ms at B 64 in bf16)."""
    return k4_bytes(B, dtype, patch, roi) / PEAK_BYTES
