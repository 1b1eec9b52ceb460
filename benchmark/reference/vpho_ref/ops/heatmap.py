"""Gaussian keypoint heatmaps (counterpart of ``vpho_tpu/ops/heatmap.py``).

Joint centres are truncated to pixels, joints outside the map give an all-zero channel, and
values are zero outside the 6 sigma + 3 stamp window.  Hand maps use the aspect-preserving
mapping, object maps the square max-side mapping; left hands' object maps move by +1 px in x.
The torch generators serve the synthetic fixture and the device preprocess; the ``_np`` ones are
the loaders' host mode (HigherHRNet stamps, the hand's resized with cv2).
"""
from __future__ import annotations

import numpy as np
import torch

from ._stamp import stamp_heatmaps


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


def square_bbox_heatmap(pt2d: torch.Tensor, bbox: torch.Tensor, out_res: int, sigma: float,
                        is_right: bool | torch.Tensor = True) -> torch.Tensor:
    """Scale by the bbox's longer side.  pt2d (..., J, 2); bbox (..., 4); is_right a bool or
    a (...,) tensor: left hands' x moves by +1 heatmap pixel."""
    max_wh = (bbox[..., 2:] - bbox[..., :2]).amax(-1, keepdim=True)
    pt_hm = (pt2d - bbox[..., None, :2]) / max_wh[..., None, :] * (out_res - 1)
    if isinstance(is_right, (bool, np.bool_)):   # a host flag: no tensor copied at each call
        shift = 0.0 if is_right else 1.0
    else:
        shift = (1.0 - torch.as_tensor(is_right, device=pt2d.device).to(pt2d.dtype))[..., None]
    x = pt_hm[..., 0] + shift
    return gaussian_heatmap(torch.stack([x, pt_hm[..., 1]], -1), out_res, sigma)


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


def adaptive_bbox_heatmap_np(pt2d, bbox, out_res: int, sigma: float) -> np.ndarray:
    """Host AdaptiveHeatmapGenerator: stamp at the aspect-preserving intermediate resolution,
    resize to (out_res, out_res) with cv2 (bilinear), zero the tail below the window's edge
    value.  pt2d (J, 2); bbox (4,) -> (J, out_res, out_res) float32."""
    import cv2

    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    max_l = max(w, h)
    res = (int(out_res * w / max_l), int(out_res * h / max_l))
    pts = np.asarray(pt2d, np.float32).copy()
    pts[:, 0] = (pts[:, 0] - bbox[0]) * res[0] / w
    pts[:, 1] = (pts[:, 1] - bbox[1]) * res[1] / h
    hm = stamp_heatmaps(pts, max(res), sigma)[:, :res[1], :res[0]]
    hm = cv2.resize(hm.transpose(1, 2, 0), (out_res, out_res), interpolation=cv2.INTER_LINEAR)
    if hm.ndim == 2:
        hm = hm[:, :, None]
    hm = hm.transpose(2, 0, 1)
    hm[hm < np.exp(-2 * (3 * sigma + 1) ** 2 / (2 * sigma ** 2))] = 0
    return hm.astype(np.float32)


def square_bbox_heatmap_np(pt2d, bbox, out_res: int, sigma: float,
                           is_right: bool = True) -> np.ndarray:
    """Host HeatmapGenerator.get_heatmap: the square max-side mapping, +1 px for left hands."""
    max_wh = max(bbox[2] - bbox[0], bbox[3] - bbox[1])
    pts = (np.asarray(pt2d, np.float32) - np.asarray(bbox[:2], np.float32)) / max_wh \
        * (out_res - 1)
    if not is_right:
        pts[:, 0] = pts[:, 0] + 1
    return stamp_heatmaps(pts, out_res, sigma)
