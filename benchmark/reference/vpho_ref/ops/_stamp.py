"""The host heatmap stamp (a copy of the port's ``native.stamp_heatmaps_np``)."""
from __future__ import annotations

import math

import numpy as np


def _llround(v: float) -> int:
    """C's ``llround``: the nearest integer, halves away from zero."""
    return int(math.copysign(math.floor(abs(v) + 0.5), v))


def stamp_heatmaps(pts: np.ndarray, res: int, sigma: float) -> np.ndarray:
    """(J, 2) pixel coordinates -> (J, res, res) Gaussian stamps (HigherHRNet semantics):
    centres truncated to integers, a window of int(6 sigma + 3) pixels from
    llround(centre - 3 sigma - 1), all-zero planes for centres off the map."""
    pts = np.ascontiguousarray(pts, np.float32)
    sigma = np.float32(sigma)
    win = int(np.float32(6) * sigma + np.float32(3))
    c0 = np.float32(3) * sigma + np.float32(1)
    g = np.arange(win, dtype=np.float32) - c0
    stamp = np.exp(-(g[:, None] * g[:, None] + g[None, :] * g[None, :])
                   / (np.float32(2) * sigma * sigma))                    # (win, win)
    out = np.zeros((pts.shape[0], res, res), np.float32)
    for j, (px, py) in enumerate(pts):
        x, y = int(px), int(py)
        if px < 0 or py < 0 or x >= res or y >= res:
            continue
        ulx = _llround(float(np.float32(x) - np.float32(3) * sigma - np.float32(1)))
        uly = _llround(float(np.float32(y) - np.float32(3) * sigma - np.float32(1)))
        x0, y0 = max(ulx, 0), max(uly, 0)
        x1, y1 = min(ulx + win, res), min(uly + win, res)
        if x1 > x0 and y1 > y0:
            out[j, y0:y1, x0:x1] = stamp[y0 - uly:y1 - uly, x0 - ulx:x1 - ulx]
    return out
