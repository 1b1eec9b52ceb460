"""Host-side numpy forms of the native data-pipeline helpers (counterpart of
``vpho_tpu/native``, whose C++ library ``cpp/libvpho_native.so`` the JAX package binds with
ctypes).  Each function computes what the C++ kernel computes, in the same float32 arithmetic
and with the same tie-breaking, so the port's items equal the JAX package's.  Farthest-point
sampling lives in ``models/ycb.py``.
"""
from __future__ import annotations

import math

import numpy as np


def min_dist(a: np.ndarray, b: np.ndarray, chunk: int = 128):
    """For each point of a (na, 3), the distance to its nearest point of b (nb, 3) and that
    point's index (the first at a tie).  Differences, not the |a|^2 + |b|^2 - 2ab expansion,
    as the C++ loop; ``chunk`` rows of a at a time bound the (chunk, nb, 3) temporary."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    dist = np.empty(a.shape[0], np.float32)
    idx = np.empty(a.shape[0], np.int64)
    for s in range(0, a.shape[0], chunk):
        d = a[s:s + chunk, None, :] - b[None]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        j = d2.argmin(-1)
        idx[s:s + chunk] = j
        dist[s:s + chunk] = np.sqrt(np.take_along_axis(d2, j[:, None], -1)[:, 0])
    return dist, idx


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


def contact_weight(normal_dist: np.ndarray, lo: float = -0.01, hi: float = 0.01,
                   decay_lo: float = -0.005, decay_hi: float = 0.005) -> np.ndarray:
    """Peak-normalized double-sigmoid band over the signed normal distances, float32
    (0 where a sigmoid's exponential overflows)."""
    nd = np.ascontiguousarray(normal_dist, np.float32)
    f = np.float32
    mid1, mid2 = f((f(decay_lo) + f(lo)) / f(2)), f((f(decay_hi) + f(hi)) / f(2))
    with np.errstate(over="ignore"):
        m1 = f(1) + np.exp(f(-1600) * (nd - mid1))
        m2 = f(1) + np.exp(f(1600) * (nd - mid2))
        v = f(1) / (m1 * m2 + f(1e-10))
        s1 = f(1) + np.exp(f(-1600) * (f(0) - mid1))
        s2 = f(1) + np.exp(f(1600) * (f(0) - mid2))
    v[~(np.isfinite(m1) & np.isfinite(m2))] = 0
    return (v / (f(1) / (s1 * s2 + f(1e-10)))).astype(np.float32)
