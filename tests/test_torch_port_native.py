"""The port's native host library (``vpho_tpu_torch/native``: ``csrc/vpho_native.cpp`` built
with g++ and bound with ctypes) against its numpy forms and the JAX package's
``vpho_tpu.native``, on random inputs with exact ties.

The library is the JAX package's C++ source built with its flags, so the two agree bit for bit
on every output.  The numpy forms agree exactly on the integer outputs (the farthest-point and
nearest-point indices, ties to the first) and within a few float32 ulps on the float ones: g++
at ``-march=native`` fuses the distance's multiply-adds and the library's exp is glibc's, while
numpy rounds every product and has its own exp.  Measured over 10^6 values: distances and
stamps at most 2 ulp apart (on 1-11% of them), contact weights at most 4 ulp (1.2e-7).
"""
import numpy as np
import pytest

import vpho_tpu.native as J
from vpho_tpu_torch import native as N


@pytest.fixture(scope="module")
def live():
    assert N.has_native() and N.HAS_NATIVE
    J._load()
    return J.HAS_NATIVE


def _clouds(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(300, 3).astype(np.float32)
    b = rng.randn(700, 3).astype(np.float32)
    b[::9] = b[4]                            # repeated points: ties in the nearest search
    a[:20] = b[4]                            # ... and zero distances
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_min_dist(live, seed):
    a, b = _clouds(seed)
    dist, idx = N.min_dist(a, b)
    dist_np, idx_np = N.min_dist_np(a, b)
    np.testing.assert_array_equal(idx, idx_np)
    assert (idx[:20] == 0).all() and (dist[:20] == 0).all()    # b[0] is b[4]'s first copy
    np.testing.assert_array_max_ulp(dist, dist_np, maxulp=2)
    if live:
        dist_j, idx_j = J.min_dist(a, b)
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(dist, dist_j)


def test_farthest_point_sampling(live):
    rng = np.random.RandomState(2)
    verts = rng.randn(2000, 3).astype(np.float32)
    verts[500:700] = verts[3]                # a block of equal points: ties in the argmax
    got = N.farthest_point_sampling(verts, 256)
    np.testing.assert_array_equal(got, N.farthest_point_sampling_np(verts, 256))
    assert len(set(got.tolist())) == 256
    if live:
        np.testing.assert_array_equal(got, J.farthest_point_sampling(verts, 256))


@pytest.mark.parametrize("sigma", [2.0, 1.5])
def test_stamp_heatmaps(live, sigma):
    rng = np.random.RandomState(3)
    pts = (rng.rand(400, 2) * 80 - 8).astype(np.float32)   # some off the map
    pts[:10] = np.floor(pts[:10])                          # on the grid exactly
    got = N.stamp_heatmaps(pts, 64, sigma)
    np.testing.assert_array_max_ulp(got, N.stamp_heatmaps_np(pts, 64, sigma), maxulp=2)
    assert ((got > 0).any((1, 2)) == ((pts >= 0) & (pts < 64)).all(1)).all()
    if live:
        np.testing.assert_array_equal(got, J.stamp_heatmaps(pts, 64, sigma))


def test_contact_weight(live):
    rng = np.random.RandomState(4)
    nd = (rng.randn(20000) * 0.01).astype(np.float32)
    nd[:4] = [0.0, -0.0075, 0.0075, 1.0]     # the peak, both band centres, an overflow
    got = N.contact_weight(nd)
    np.testing.assert_array_max_ulp(got, N.contact_weight_np(nd), maxulp=4)
    assert got[3] == 0.0
    if live:
        np.testing.assert_array_equal(got, J.contact_weight(nd))
