"""Dual-stream ResNet-50 FPN backbone (counterpart of ``vpho_tpu/models/backbone.py``), NCHW.

The two streams share the stem, layer1 and layer4 and keep separate layer2/layer3; each has
its own FPN top-down path down to P2 (stride 4), and the object P2 lateral reuses the shared
c2.  The bottlenecks use LeakyReLU(0.01), as the reference does.  For a 256x256 crop the
outputs are two (B, 256, 64, 64) maps.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import resize_bilinear
from .layers import BatchNorm2d, Conv2d, bn_act


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 compute_dtype=None):
        super().__init__()
        d = compute_dtype
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, compute_dtype=d)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                            compute_dtype=d)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, compute_dtype=d)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False, compute_dtype=d),
            BatchNorm2d(planes * 4),
        ) if downsample else None

    def forward(self, x):
        out = bn_act(self.bn1, self.conv1(x), "leaky")
        out = bn_act(self.bn2, self.conv2(out), "leaky")
        residual = x if self.downsample is None else self.downsample(x)
        return bn_act(self.bn3, self.conv3(out), "leaky", residual)


def _res_layer(inplanes: int, planes: int, blocks: int, stride: int, compute_dtype):
    layers = [Bottleneck(inplanes, planes, stride, True, compute_dtype)]
    layers += [Bottleneck(planes * 4, planes, 1, False, compute_dtype) for _ in range(1, blocks)]
    # wrapped once more so the keys read ``layerN_x.0.<block>`` as in the reference
    return nn.Sequential(nn.Sequential(*layers))


def _upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, y.shape[-2:]) + y


class FPNBackbone(nn.Module):
    def __init__(self, compute_dtype=None):
        super().__init__()
        d = compute_dtype
        self.compute_dtype = d
        self.layer0_h = nn.Sequential(Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                                             compute_dtype=d), BatchNorm2d(64))
        self.layer1_h = _res_layer(64, 64, 3, 1, d)
        self.layer2_h = _res_layer(256, 128, 4, 2, d)
        self.layer2_o = _res_layer(256, 128, 4, 2, d)
        self.layer3_h = _res_layer(512, 256, 6, 2, d)
        self.layer3_o = _res_layer(512, 256, 6, 2, d)
        self.layer4_h = _res_layer(1024, 512, 3, 2, d)
        for side in ("h", "o"):
            setattr(self, f"toplayer_{side}", Conv2d(2048, 256, 1, compute_dtype=d))
            setattr(self, f"latlayer1_{side}", Conv2d(1024, 256, 1, compute_dtype=d))
            setattr(self, f"latlayer2_{side}", Conv2d(512, 256, 1, compute_dtype=d))
            setattr(self, f"latlayer3_{side}", Conv2d(256, 256, 1, compute_dtype=d))
            setattr(self, f"smooth3_{side}", Conv2d(256, 256, 3, padding=1, compute_dtype=d))

    def _top_down(self, side: str, c2, c3, c4, c5):
        p5 = getattr(self, f"toplayer_{side}")(c5)
        p4 = _upsample_add(p5, getattr(self, f"latlayer1_{side}")(c4))
        p3 = _upsample_add(p4, getattr(self, f"latlayer2_{side}")(c3))
        p2 = _upsample_add(p3, getattr(self, f"latlayer3_{side}")(c2))
        return getattr(self, f"smooth3_{side}")(p2)

    def forward(self, x):
        """x (B, 3, H, W) -> (p2_hand, p2_obj), each (B, 256, H/4, W/4)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        conv, bn = self.layer0_h
        c1 = F.max_pool2d(bn_act(bn, conv(x), "leaky"), 3, 2, 1)
        c2 = self.layer1_h(c1)
        c3_h, c3_o = self.layer2_h(c2), self.layer2_o(c2)
        c4_h, c4_o = self.layer3_h(c3_h), self.layer3_o(c3_o)
        c5_h, c5_o = self.layer4_h(c4_h), self.layer4_h(c4_o)
        return (self._top_down("h", c2, c3_h, c4_h, c5_h),
                self._top_down("o", c2, c3_o, c4_o, c5_o))
