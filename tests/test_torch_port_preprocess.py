"""The port's device preprocess (``--device_preprocess``) on the CPU against the JAX package's:
the colour ops, ``affine_warp``, ``preprocess_batch`` on a mini DexYCB's device-mode batches,
the left-hand heatmap shift, and the train-mode refusal without noise.

Same inputs and the same erase noise (JAX's own draw, ``jax.random.normal`` on the key its
``erase_regions`` gets) go to both packages.  Bars:
  * colour ops: rtol 1e-5 (hue's wrap: atol 1e-3 on the 0-255 scale);
  * the warp without rotation (eval crops) against JAX's rectilinear path: within 1e-3
    levels, both float32;
  * the warp under rotation (train crops) against JAX's general path: the port computes in
    float32 where JAX casts the image, weights and intermediate to bfloat16, so within a
    band: mean |diff| < 0.5 and max < 4 levels (measured 0.23 and 1.4 on the natural image
    below);
  * both warps against ``cv2.warpAffine`` on the JAX package's own bars
    (``tests/test_device_pipeline.py``);
  * ``preprocess_batch``: eval rgb within 1e-4 (normalized units), train rgb within the
    warp's bf16 band carried through normalization (mean < 0.01, max < 0.1), heatmaps within
    1e-5.
"""
import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from vpho_tpu.data.device_pipeline import preprocess_batch as jax_preprocess
from vpho_tpu.ops import color as JC
from vpho_tpu.ops.heatmap import square_bbox_heatmap as jax_square_hm
from vpho_tpu.ops.image import affine_warp as jax_warp
from vpho_tpu_torch.configs.config import Config
from vpho_tpu_torch.data import dexycb as D
from vpho_tpu_torch.data.device_pipeline import make_device_preprocess, preprocess_batch
from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb
from vpho_tpu_torch.ops import color as TC
from vpho_tpu_torch.ops.heatmap import square_bbox_heatmap
from vpho_tpu_torch.ops.image import affine_warp

torch.set_num_threads(1)
t = torch.from_numpy


def _natural(rng, H=120, W=160):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([127 + 80 * np.sin(xx / 17) + 10 * rng.randn(H, W),
                    127 + 80 * np.cos(yy / 23) + 10 * rng.randn(H, W),
                    127 + 60 * np.sin((xx + yy) / 31) + 10 * rng.randn(H, W)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_color_ops_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.rand(3, 40, 48, 3) * 255).astype(np.float32)
    bcsh = np.array([[1.1, 0.8, 1.2, 0.1], [0.7, 1.3, 0.6, -0.14], [1, 1, 1, 0]], np.float32)
    np.testing.assert_allclose(TC.color_jitter(t(x), t(bcsh)).numpy(),
                               np.asarray(JC.color_jitter(x, bcsh)), rtol=1e-5, atol=1e-3)
    shift = rng.randint(-20, 21, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(TC.rgb_shift(t(x), t(shift)).numpy(),
                               np.asarray(JC.rgb_shift(x, shift)), rtol=1e-5)
    ks = np.zeros((3, 13, 13), np.float32)
    ks[0] = rng.rand(13, 13) / 85
    ks[1, 6, 6] = 1.0
    ks[2, 4:9, 3:10] = rng.rand(5, 7) / 17
    np.testing.assert_allclose(TC.depthwise_blur(t(x), t(ks)).numpy(),
                               np.asarray(JC.depthwise_blur(x, ks)), rtol=1e-5, atol=1e-3)
    hsv = TC.rgb_to_hsv_cv2(t(x))
    np.testing.assert_allclose(TC.hsv_to_rgb_cv2(hsv).numpy(), x, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode", ["pixel", "rand", "const"])
def test_erase_regions_match_jax_with_the_same_noise(mode):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 40, 48, 3).astype(np.float32)
    rects = np.array([[[3, 4, 10, 12], [20, 10, 8, 30]], [[0, 0, 0, 0], [0, 0, 0, 0]],
                      [[5, 5, 30, 40], [1, 2, 3, 4]]], np.int32)
    key = jax.random.PRNGKey(3)
    shape = TC.erase_noise_shape(mode, 3, 2, 40, 48, 3)
    noise = None if shape is None else t(np.array(jax.random.normal(key, shape, jnp.float32)))
    got = TC.erase_regions(t(x), t(rects), noise, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(JC.erase_regions(x, rects, key, mode=mode)),
                               rtol=1e-5)
    assert not np.allclose(got.numpy(), x)
    if mode != "const":
        with pytest.raises(ValueError, match="noise"):
            TC.erase_regions(t(x), t(rects), None, mode)


def _warp_case(rot_deg, noise=False):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (1, 120, 160, 3)).astype(np.uint8) if noise else _natural(rng)[None]
    th, s = np.deg2rad(rot_deg), 0.9
    A = np.array([[s * np.cos(th), -s * np.sin(th), 20.0], [s * np.sin(th), s * np.cos(th), -8.0],
                  [0, 0, 1.0]])
    ref = cv2.warpAffine(img[0], A[:2].astype(np.float32), (64, 64), flags=cv2.INTER_CUBIC)
    minv = np.linalg.inv(A)[:2].astype(np.float32)[None]
    rect = rot_deg == 0
    got = affine_warp(t(img), t(minv), 64).numpy()
    jx = np.asarray(jax_warp(img.astype(np.float32), minv, 64, rectilinear=rect))
    # the 2 px frame is left out against cv2: cv2 treats out-of-image taps at the crop's
    # border slightly differently from zero padding
    vs_cv2 = np.abs(np.clip(got, 0, 255)[0, 2:-2, 2:-2] - ref[2:-2, 2:-2].astype(np.float32))
    return got, jx, vs_cv2


def test_unrotated_warp_matches_jax_rectilinear_and_cv2():
    got, jx, vs_cv2 = _warp_case(0)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-3)
    assert vs_cv2.mean() < 0.5 and vs_cv2.max() < 4.0, (vs_cv2.mean(), vs_cv2.max())


def test_rotated_warp_within_the_bf16_band_of_jax_and_matches_cv2():
    got, jx, vs_cv2 = _warp_case(17)
    d = np.abs(got - jx)
    assert d.mean() < 0.5 and d.max() < 4.0, (d.mean(), d.max())
    assert vs_cv2.mean() < 1.6 and np.percentile(vs_cv2, 99) < 7.0 and vs_cv2.max() < 16.0
    _, _, noise = _warp_case(17, noise=True)
    assert noise.mean() < 9.0 and noise.max() < 60.0, (noise.mean(), noise.max())


def test_warp_of_crops_past_the_frame_or_off_it_matches_jax():
    """Crops that reach past the top or the bottom of the frame, or miss it, alone and in one
    batch, meet JAX's full-frame warp (rectilinear, 1e-3); the one off the frame is all zero."""
    img = _natural(np.random.RandomState(2))[None].repeat(3, 0)
    A = np.array([[[0.8, 0, 10.0], [0, 0.8, 30.0]],        # rows -38 .. 1: cut at the top
                  [[1.5, 0, -20.0], [0, 1.5, -150.0]],     # rows 100 .. 121: cut at the bottom
                  [[1.0, 0, 0.0], [0, 1.0, 200.0]]])        # above the frame: all zero
    minv = np.stack([np.linalg.inv(np.vstack([a, [0, 0, 1]]))[:2] for a in A]).astype(np.float32)
    for sel in ([0], [1], [2], [0, 1]):
        got = affine_warp(t(img[sel]), t(minv[sel]), 32).numpy()
        ref = np.asarray(jax_warp(img[sel].astype(np.float32), minv[sel], 32, rectilinear=True))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert not affine_warp(t(img[2:]), t(minv[2:]), 32).any()


def test_left_hand_heatmap_shift():
    rng = np.random.RandomState(4)
    pts = (rng.rand(2, 27, 2) * 50 + 5).astype(np.float32)
    bbox = np.array([[0, 0, 64, 60], [2, 3, 60, 64]], np.float32)
    is_right = np.array([True, False])
    got = square_bbox_heatmap(t(pts), t(bbox), 64, 2.0, t(is_right)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_square_hm(pts, bbox, 64, 2.0, is_right)),
                               rtol=0, atol=1e-6)
    right = square_bbox_heatmap(t(pts), t(bbox), 64, 2.0).numpy()
    np.testing.assert_array_equal(got[0], right[0])
    assert not np.allclose(got[1], right[1])       # the left hand's map moves by +1 px in x
    np.testing.assert_array_equal(square_bbox_heatmap(t(pts[1:]), t(bbox[1:]), 64, 2.0, False).numpy(),
                                  got[1:])


@pytest.fixture(scope="module")
def device_batches(tmp_path_factory):
    """Device-mode batches of a mini DexYCB (one left hand), eval and train, patch 64."""
    root = build_mini_dexycb(str(tmp_path_factory.mktemp("dex_pre")), n=4, seed=3,
                             sides=["right", "left", "right", "right"])
    out = {}
    for is_train in (False, True):
        cfg = Config(data_dir=root, patch_size=64, device_preprocess=True)
        ds = D.DexYCBForceDataset(cfg, root, is_train=is_train)
        out[is_train] = (cfg, D.collate([ds[i] for i in range(4)]))
    return out


def _both(cfg, raw, is_train, key):
    kw = dict(patch_size=64, heatmap_size=cfg.heatmap_size, hand_sigma=cfg.heatmap_hand_sigma,
              obj_sigma=cfg.heatmap_obj_sigma, is_train=is_train)
    ref = jax_preprocess({k: jnp.asarray(v) for k, v in raw.items()}, key, **kw)
    noise = None
    if is_train:
        shape = TC.erase_noise_shape("pixel", 4, raw["erase_rects"].shape[1], 64, 64, 3)
        noise = t(np.array(jax.random.normal(key, shape, jnp.float32)))
    got = preprocess_batch({k: torch.as_tensor(v) for k, v in raw.items()}, noise=noise, **kw)
    return ref, got


@pytest.mark.parametrize("is_train", [False, True])
def test_preprocess_batch_matches_jax(device_batches, is_train):
    cfg, raw = device_batches[is_train]
    ref, got = _both(cfg, raw, is_train, jax.random.PRNGKey(5))
    assert sorted(got) == sorted(ref) and "rgb_full" not in got
    d = np.abs(got["rgb"].numpy() - np.asarray(ref["rgb"]))
    if is_train:
        assert raw["warp_minv"][:, 0, 1].any()             # a rotated crop is in the batch
        assert d.mean() < 0.01 and d.max() < 0.1, (d.mean(), d.max())
    else:
        assert d.max() < 1e-4, d.max()
    for k in ("hm_hand", "hm_obj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5)
    for k in ("gt_obj", "bbox_hand", "is_right", "obj_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_train_preprocess_needs_noise(device_batches):
    cfg, raw = device_batches[True]
    batch = {k: torch.as_tensor(v) for k, v in raw.items()}
    pre = make_device_preprocess(cfg, is_train=True)
    with pytest.raises(ValueError, match="generator"):
        pre(batch)
    a = pre(batch, generator=torch.Generator().manual_seed(0))["rgb"]
    b = pre(batch, generator=torch.Generator().manual_seed(0))["rgb"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    host = {k: v for k, v in batch.items() if k not in ("rgb_full",)}
    assert make_device_preprocess(cfg, is_train=True)(host) is host   # host-mode batches pass


def test_device_preprocess_refuses_large_rotations(device_batches):
    cfg, _ = device_batches[True]
    with pytest.raises(ValueError, match="max_rot"):
        D.DexYCBForceDataset(Config(data_dir=cfg.data_dir, patch_size=64, device_preprocess=True,
                                    max_rot=85.0), cfg.data_dir, is_train=True)
