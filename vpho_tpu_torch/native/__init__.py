"""Host helpers of the data pipeline (counterpart of ``vpho_tpu/native``): farthest-point
sampling, the nearest-point search, Gaussian heatmap stamping and the contact-band weight.

The port keeps its own copy of the JAX package's C++ library, ``csrc/vpho_native.cpp``.  The
first call builds it with ``g++ -O3 -march=native -shared -fPIC`` into
``build/vpho_tpu_torch/libvpho_native_<hash>.so`` (under the kernels' build lock) and binds it
with ctypes: the same source and flags as the JAX package's ``cpp/libvpho_native.so``, so the
two libraries give the same bits.  ``has_native()`` (and ``HAS_NATIVE`` after it) says which
path is live, and the choice is logged once.  On a host without ``g++`` the functions run
their numpy forms (``*_np``); a build that fails raises.

The numpy forms are the plain versions: the C++ loops' float32 arithmetic and tie-breaking
in numpy.  Their indices equal the library's; their floats can differ from it by an ulp,
since the library's ``exp`` is glibc's and ``-march=native`` lets g++ fuse multiply-adds.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR, build_lock

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "vpho_native.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

HAS_NATIVE = False
_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libvpho_native_{digest[:16]}.so"


def _build(out: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{res.stderr}")
    os.replace(tmp, out)


def _load():
    """The bound library, built first if needed; None on a host without g++."""
    with _LOCK:
        return _LIB if _TRIED else _bind()


def _bind():
    global _LIB, HAS_NATIVE, _TRIED
    out = library_path()
    if not out.exists() and shutil.which("g++") is None:
        _TRIED = True
        logging.getLogger("vpho_torch").warning(
            "native host helpers: no g++ on this host, running their numpy forms")
        return None
    with build_lock():
        if not out.exists():
            _build(out)
    lib = ctypes.CDLL(str(out))
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vpho_fps.argtypes = [f32p, i64, i64, i64, i64p]
    lib.vpho_min_dist.argtypes = [f32p, i64, f32p, i64, f32p, i64p]
    lib.vpho_stamp_heatmaps.argtypes = [f32p, i64, i64, ctypes.c_float, f32p]
    lib.vpho_contact_weight.argtypes = [f32p, i64, ctypes.c_float, ctypes.c_float,
                                        ctypes.c_float, ctypes.c_float, f32p]
    _LIB, HAS_NATIVE, _TRIED = lib, True, True
    logging.getLogger("vpho_torch").info(f"native host helpers: {out.name}")
    return lib


def has_native() -> bool:
    """Whether the C++ library is live (building it if needed)."""
    return _load() is not None


def farthest_point_sampling(verts: np.ndarray, k: int, start_idx: int = 0) -> np.ndarray:
    """Indices of ``k`` farthest-point samples of verts (n, 3), from ``start_idx``."""
    verts = np.ascontiguousarray(verts, np.float32)
    n = verts.shape[0]
    if n <= k:
        return np.arange(n)
    lib = _load()
    if lib is None:
        return farthest_point_sampling_np(verts, k, start_idx)
    out = np.empty(k, np.int64)
    lib.vpho_fps(verts, n, k, start_idx, out)
    return out


def min_dist(a: np.ndarray, b: np.ndarray):
    """For each point of a (na, 3), the distance to its nearest point of b (nb, 3) and that
    point's index (the first at a tie)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    lib = _load()
    if lib is None:
        return min_dist_np(a, b)
    dist = np.empty(a.shape[0], np.float32)
    idx = np.empty(a.shape[0], np.int64)
    lib.vpho_min_dist(a, a.shape[0], b, b.shape[0], dist, idx)
    return dist, idx


def stamp_heatmaps(pts: np.ndarray, res: int, sigma: float) -> np.ndarray:
    """(J, 2) pixel coordinates -> (J, res, res) Gaussian stamps (``stamp_heatmaps_np``)."""
    pts = np.ascontiguousarray(pts, np.float32)
    lib = _load()
    if lib is None:
        return stamp_heatmaps_np(pts, res, sigma)
    out = np.empty((pts.shape[0], res, res), np.float32)
    lib.vpho_stamp_heatmaps(pts, pts.shape[0], res, sigma, out)
    return out


def contact_weight(normal_dist: np.ndarray, lo: float = -0.01, hi: float = 0.01,
                   decay_lo: float = -0.005, decay_hi: float = 0.005) -> np.ndarray:
    """The contact-band weight of signed normal distances (``contact_weight_np``)."""
    nd = np.ascontiguousarray(normal_dist, np.float32)
    lib = _load()
    if lib is None:
        return contact_weight_np(nd, lo, hi, decay_lo, decay_hi)
    out = np.empty(nd.shape[0], np.float32)
    lib.vpho_contact_weight(nd, nd.shape[0], lo, hi, decay_lo, decay_hi, out)
    return out


def farthest_point_sampling_np(verts: np.ndarray, k: int, start_idx: int = 0) -> np.ndarray:
    """The numpy form of ``farthest_point_sampling`` (the first farthest point at a tie)."""
    verts = np.ascontiguousarray(verts, np.float32)
    if verts.shape[0] <= k:
        return np.arange(verts.shape[0])
    chosen = np.empty(k, np.int64)
    chosen[0] = start_idx
    d = verts - verts[start_idx]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    for i in range(1, k):
        idx = int(d2.argmax())
        chosen[i] = idx
        d = verts - verts[idx]
        d2 = np.minimum(d2, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    return chosen


def min_dist_np(a: np.ndarray, b: np.ndarray, chunk: int = 128):
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


def stamp_heatmaps_np(pts: np.ndarray, res: int, sigma: float) -> np.ndarray:
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


def contact_weight_np(normal_dist: np.ndarray, lo: float = -0.01, hi: float = 0.01,
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
