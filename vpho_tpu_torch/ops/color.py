"""Colour augmentation of the device preprocess (counterpart of ``vpho_tpu/ops/color.py``).

Batched torch forms of the host cv2 pipeline in ``data/augment.py``, on float32 RGB in
[0, 255], NHWC (the host path round-trips uint8 between stages; the device path does not).
HSV follows cv2's uint8 convention: H in [0, 180), S and V in [0, 255].  Randomness is an
input: ``erase_regions`` takes its noise as a tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rgb_to_hsv_cv2(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB 0..255 -> (..., 3) HSV, H in [0, 180) as cv2 stores it."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = v - mn
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(delta > 0, torch.remainder(h, 360.0), torch.zeros_like(h)) / 2.0
    s = torch.where(v > 0, delta * 255.0 / torch.where(v > 0, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_cv2(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv_cv2` (continuous hue)."""
    hp = hsv[..., 0] * 2.0 / 60.0
    v = hsv[..., 2]
    c = v * hsv[..., 1] / 255.0
    xw = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    sector = [hp < 1, hp < 2, hp < 3, hp < 4, hp < 5]

    def select(choices, default):
        out = default
        for cond, val in zip(reversed(sector), reversed(choices)):
            out = torch.where(cond, val, out)
        return out

    r = select([c, xw, z, z, xw], c)
    g = select([xw, c, c, xw, z], z)
    b = select([z, z, xw, c, c], xw)
    m = v - c
    return torch.stack([r + m, g + m, b + m], dim=-1)


def color_jitter(x: torch.Tensor, bcsh: torch.Tensor) -> torch.Tensor:
    """Per-sample brightness, contrast (about the image's mean after brightness), saturation
    (the HSV S channel) and hue (+ hue x 180, mod 180), in that order.  x (B, H, W, 3);
    bcsh (B, 4), identity (1, 1, 1, 0)."""
    f = x * bcsh[:, 0, None, None, None]
    mean = f.mean(dim=(1, 2, 3), keepdim=True)
    f = ((f - mean) * bcsh[:, 1, None, None, None] + mean).clamp(0.0, 255.0)
    hsv = rgb_to_hsv_cv2(f)
    s = (hsv[..., 1] * bcsh[:, 2, None, None]).clamp(0.0, 255.0)
    h = torch.remainder(hsv[..., 0] + bcsh[:, 3, None, None] * 180.0, 180.0)
    return hsv_to_rgb_cv2(torch.stack([h, s, hsv[..., 2]], dim=-1)).clamp(0.0, 255.0)


def rgb_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) 0..255; shift (B, 3) added per channel, then clipped."""
    return (x + shift[:, None, None, :]).clamp(0.0, 255.0)


def depthwise_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample correlation with one (k, k) kernel over all channels, reflect-101 border.

    x (B, H, W, 3); kernels (B, k, k), a centred delta where a sample's blur did not trigger.
    The host applies its Gaussian and motion blurs in turn; the loader composes them into one
    kernel.  One ``conv2d`` with a group per (sample, channel): in float32 a depthwise
    convolution runs PyTorch's own direct kernel on the card, not cuDNN's TF32 tensor cores.
    """
    B, H, W, C = x.shape
    k = kernels.shape[-1]
    xp = F.pad(x.permute(0, 3, 1, 2).reshape(1, B * C, H, W), (k // 2,) * 4, mode="reflect")
    weight = kernels.to(x.dtype).repeat_interleave(C, dim=0)[:, None]       # (B*C, 1, k, k)
    out = F.conv2d(xp, weight, groups=B * C)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)


def erase_noise_shape(mode: str, B: int, R: int, H: int, W: int, C: int):
    """Shape of ``erase_regions``' noise (the JAX package's draw), None for 'const'."""
    return {"pixel": (B, 1, H, W, C), "rand": (B, R, 1, 1, C), "const": None}[mode]


def erase_regions(x: torch.Tensor, rects: torch.Tensor, noise: torch.Tensor | None,
                  mode: str = "pixel") -> torch.Tensor:
    """timm RandomErasing fills on the normalized image.

    x (B, H, W, C); rects (B, R, 4) int (y, x, h, w), h = 0 in unused slots; noise of
    ``erase_noise_shape(mode, ...)``: one unit-normal value a pixel ('pixel', shared by the
    regions), one colour a region ('rand'), or None ('const': zeros).  Later regions overwrite
    earlier ones.
    """
    B, H, W, C = x.shape
    if mode not in ("pixel", "rand", "const"):
        raise ValueError(mode)
    want = erase_noise_shape(mode, B, rects.shape[1], H, W, C)
    if want is not None and (noise is None or tuple(noise.shape) != want):
        raise ValueError(f"erase_regions({mode!r}): noise of shape {want} required, got "
                         f"{None if noise is None else tuple(noise.shape)}")
    ii = torch.arange(H, device=x.device)[None, :, None]
    jj = torch.arange(W, device=x.device)[None, None, :]
    out = x
    for r in range(rects.shape[1]):
        y0, x0, h, w = (rects[:, r, k, None, None] for k in range(4))
        mask = (ii >= y0) & (ii < y0 + h) & (jj >= x0) & (jj < x0 + w)     # (B, H, W)
        fill = torch.zeros_like(x) if noise is None else \
            noise[:, 0 if mode == "pixel" else r].to(x.dtype).expand(B, H, W, C)
        out = torch.where(mask[..., None], fill, out)
    return out
