"""Gaussian keypoint heatmaps (counterpart of ``vpho_tpu/ops/heatmap.py``, the two builders
the synthetic fixture uses).

Joint centres are truncated to pixels, joints outside the map give an all-zero channel, and
values are zero outside the 6 sigma + 3 stamp window.  Hand maps use the aspect-preserving
mapping, object maps the square max-side mapping.
"""
from __future__ import annotations

import torch


def _window_gauss(d: torch.Tensor, sigma: float) -> torch.Tensor:
    return torch.exp(-(d ** 2) / (2 * sigma ** 2)) * (d.abs() <= 3.0 * sigma + 1.0)


def gaussian_heatmap(pt2d_px: torch.Tensor, out_res: int, sigma: float) -> torch.Tensor:
    """pt2d_px (..., J, 2) pixel coords -> (..., J, out_res, out_res)."""
    x, y = torch.floor(pt2d_px[..., 0]), torch.floor(pt2d_px[..., 1])
    in_range = (x >= 0) & (y >= 0) & (x < out_res) & (y < out_res)
    grid = torch.arange(out_res, dtype=pt2d_px.dtype, device=pt2d_px.device)
    gx = _window_gauss(grid - x[..., None], sigma)
    gy = _window_gauss(grid - y[..., None], sigma)
    return gy[..., :, None] * gx[..., None, :] * in_range[..., None, None]


def square_bbox_heatmap(pt2d: torch.Tensor, bbox: torch.Tensor, out_res: int,
                        sigma: float) -> torch.Tensor:
    """Scale by the bbox's longer side (right hands).  pt2d (..., J, 2); bbox (..., 4)."""
    max_wh = (bbox[..., 2:] - bbox[..., :2]).amax(-1, keepdim=True)
    pt_hm = (pt2d - bbox[..., None, :2]) / max_wh[..., None, :] * (out_res - 1)
    return gaussian_heatmap(pt_hm, out_res, sigma)


def adaptive_bbox_heatmap(pt2d: torch.Tensor, bbox: torch.Tensor, out_res: int,
                          sigma: float) -> torch.Tensor:
    """The aspect-preserving stamp evaluated directly on the final stretched grid."""
    wh = bbox[..., 2:] - bbox[..., :2]
    res = torch.floor(out_res * wh / wh.amax(-1, keepdim=True))     # intermediate resolution
    pt_hm = (pt2d - bbox[..., None, :2]) * (res / wh)[..., None, :]
    stretch = res / out_res
    x = torch.floor(pt_hm[..., 0]) / stretch[..., None, 0]
    y = torch.floor(pt_hm[..., 1]) / stretch[..., None, 1]
    in_range = ((pt_hm[..., 0] >= 0) & (pt_hm[..., 1] >= 0)
                & (pt_hm[..., 0] < res[..., None, 0]) & (pt_hm[..., 1] < res[..., None, 1]))
    grid = torch.arange(out_res, dtype=pt2d.dtype, device=pt2d.device)
    gx = _window_gauss((grid - x[..., None]) * stretch[..., None, 0:1], sigma)
    gy = _window_gauss((grid - y[..., None]) * stretch[..., None, 1:2], sigma)
    return gy[..., :, None] * gx[..., None, :] * in_range[..., None, None]
