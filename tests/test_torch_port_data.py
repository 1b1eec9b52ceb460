"""The port's DexYCB loader against the JAX package's on a mini tree (4 frames of 640x480, one
left hand): items key for key in train and eval, host and device mode; the contact labels;
``collate`` / ``make_loader`` with ``drop_last=False``; the augmentation draws; the index cache;
the refusal to read frames without cv2.

The tree is built twice, the same files in two directories, so that each package computes its
own contact labels (both cache them under the data directory, in the same files).  Bars:
  * integer, boolean and drawn fields (index, obj_id, is_right, the drawn shift, jitter,
    blur kernel and erase rects): equal;
  * geometry (FK-corrected translation, vertices, joints, object pose, boxes, intrinsics,
    the crop's affine): rtol 1e-5, atol 1e-6 (the two FKs round differently in float32);
  * host-mode rgb: both packages crop and augment with the same cv2, atol 1e-5;
  * heatmaps and contact weights: atol 1e-5 (float32 exp in C++ against numpy).
"""
import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from vpho_tpu.configs.config import Config as JConfig
from vpho_tpu.data import augment as JA
from vpho_tpu.data import dexycb as JD
from vpho_tpu_torch.configs.config import Config
from vpho_tpu_torch.data import augment as TA
from vpho_tpu_torch.data import dexycb as D
from vpho_tpu_torch.data.fixtures_disk import build_mini_dexycb

torch.set_num_threads(1)

SIDES = ["right", "left", "right", "right"]
EXACT = ("index", "obj_id", "is_right", "is_ho3d", "is_grasped", "rgb_shift", "jitter_bcsh",
         "blur_kernel", "erase_rects", "rgb_full")
LOOSE = ("rgb", "hm_hand", "hm_obj", "force_contact")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(port's root, JAX's root): the same mini DexYCB twice.  The JAX loader's registry (the
    same synthetic constants every time) is built once for the module."""
    root = build_mini_dexycb(str(tmp_path_factory.mktemp("dex_port")), n=4, seed=3, sides=SIDES)
    jroot = str(tmp_path_factory.mktemp("dex_jax"))
    shutil.copytree(root, jroot, dirs_exist_ok=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(JD, "load_registry", functools.lru_cache(maxsize=2)(JD.load_registry))
    yield root, jroot
    mp.undo()


def _datasets(trees, is_train, device, **over):
    root, jroot = trees
    kw = dict(patch_size=128, device_preprocess=device, **over)
    return (D.DexYCBForceDataset(Config(data_dir=root, **kw), root, is_train=is_train),
            JD.DexYCBForceDataset(JConfig(data_dir=jroot, **kw), jroot, is_train=is_train))


def assert_same_item(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype, r.dtype, g.shape, r.shape)
        if k in EXACT or r.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in LOOSE:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("is_train,device", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_items_match_jax(trees, is_train, device):
    port, jax_ds = _datasets(trees, is_train, device)
    assert len(port) == len(jax_ds) == 4 and port.index_ls == jax_ds.index_ls
    for i in range(4):
        got, ref = port[i], jax_ds[i]
        assert_same_item(got, ref)
        assert ("rgb_full" in got) == device and ("rgb" in got) != device
    if is_train and device:
        assert any(np.asarray(port[i]["erase_rects"])[:, 2].any() for i in range(4))
        # the left hand's affine carries the flip and its blur kernel is mirrored
        assert np.asarray(port[1]["warp_minv"])[0, 0] < 0


def test_contact_labels_match_jax(trees):
    port, jax_ds = _datasets(trees, False, False)
    for i in range(4):
        assert float(port[i]["force_contact"].max()) > 0       # the fixture's hands touch
    model = D.host_mano("right")
    rng = np.random.RandomState(0)
    verts, _ = D.get_hand_vert(rng.randn(45) * 0.1, rng.randn(10) * 0.3, rng.randn(3) * 0.2,
                               np.array([0.0, 0.01, 0.55]), True)
    obj = port.host.verts_full[3] * 0.5 + np.array([0.0, 0.01, 0.56], np.float32)
    got = D.signed_contact_weights(verts, model.faces, obj)
    ref = JD.signed_contact_weights(verts, np.asarray(model.faces), obj)
    assert (ref > 0).sum() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(D.vertex_normals(verts, model.faces),
                               JD.vertex_normals(verts, model.faces), rtol=1e-5, atol=1e-6)


def test_anchor_host_helpers_match_jax(trees):
    """The loaders' anchor helpers (contact pooled to the 32 anchors, the grasp test) and
    ``force_global_to_local``: equal to the JAX package's, and the transpose of
    ``force_local_to_global`` on the same hand (rtol 1e-5)."""
    from vpho_tpu.models import anchor as janchor
    from vpho_tpu_torch.models import anchor as tanchor

    port, jax_ds = _datasets(trees, False, False)
    rng = np.random.RandomState(5)
    contact = (rng.rand(3, 778) * (rng.rand(3, 778) < 0.1)).astype(np.float32)
    contact[2] = 0.0
    got = tanchor.pool_contact_to_anchors_np(port.tables, contact)
    np.testing.assert_allclose(got, janchor.pool_contact_to_anchors_np(jax_ds.tables, contact),
                               rtol=1e-6, atol=0)
    assert ([tanchor.check_is_grasped_np(c) for c in got]
            == [janchor.check_is_grasped_np(c) for c in got] == [True, True, False])
    verts, _ = D.get_hand_vert(rng.randn(45) * 0.3, rng.randn(10) * 0.3, rng.randn(3) * 0.2,
                               np.array([0.0, 0.01, 0.55]), True)
    verts = torch.as_tensor(np.asarray(verts, np.float32))
    fl = torch.as_tensor((rng.randn(2, 32, 3) * 0.1).astype(np.float32))
    _, fg = tanchor.force_local_to_global(port.tables, fl, verts)
    back = tanchor.force_global_to_local(port.tables, fg, verts)
    # the frame's axes are orthogonal but not unit (x = y x z is never renormalized, and the
    # normalizing eps shortens the mesh's millimetre-scale normals): each local component
    # comes back scaled by its axis's squared length
    col_sq = (tanchor.anchor_points_and_frames(port.tables, verts)[1] ** 2).sum(-2)
    np.testing.assert_allclose(back.numpy(), (fl * col_sq).numpy(), rtol=1e-5, atol=1e-6)
    ref = janchor.force_global_to_local(jax_ds.tables, fg.numpy(), verts.numpy())
    np.testing.assert_allclose(back.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_loader_pads_the_tail_and_indexes_it(trees):
    port, jax_ds = _datasets(trees, False, True)
    got = list(D.make_loader(port, 3, drop_last=False))
    ref = list(JD.make_loader(jax_ds, 3, drop_last=False, num_workers=2))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["_valid"], r["_valid"])
        np.testing.assert_array_equal(g["_index"], r["_index"])
        assert_same_item({k: v for k, v in g.items() if not k.startswith("_")},
                         {k: v for k, v in r.items() if not k.startswith("_")})
    np.testing.assert_array_equal(got[1]["_valid"], [True, False, False])
    np.testing.assert_array_equal(got[1]["_index"], [3, 3, 3])   # the padding repeats item 3
    assert got[1]["obj_id"].shape == (3,) and len(set(got[1]["obj_id"])) == 1
    train = list(D.make_loader(port, 3, shuffle=True, seed=2))
    assert len(train) == 1 and "_valid" not in train[0]


def test_index_cache_is_the_jax_packages(trees):
    root, jroot = trees
    for r in (root, jroot):
        shutil.rmtree(os.path.join(r, "cache", "annotation"), ignore_errors=True)
    _datasets(trees, True, False)
    name = os.path.join("cache", "annotation", "2023_CVPR_HFL_train_index_tpu.json")
    with open(os.path.join(root, name)) as f, open(os.path.join(jroot, name)) as g:
        assert json.load(f) == json.load(g) == ["s0", "s1", "s2", "s3"]


@pytest.mark.parametrize("mirror", [False, True])
def test_device_draws_match_jax(mirror):
    cfg = Config(random_erasing_prob=0.9, gaussian_blur_prob=0.7, motion_blur_prob=0.7)
    got_aug, ref_aug = TA.ImageAugmentor.from_config(cfg), JA.ImageAugmentor.from_config(cfg)
    for seed in range(12):
        got = got_aug.sample_device_params(np.random.RandomState(seed), 64, mirror=mirror)
        ref = ref_aug.sample_device_params(np.random.RandomState(seed), 64, mirror=mirror)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    img = (np.random.RandomState(1).rand(48, 48, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got_aug.run_color(img, np.random.RandomState(3)),
                                  ref_aug.run_color(img, np.random.RandomState(3)))
    norm = TA.normalize_rgb(img)
    np.testing.assert_array_equal(got_aug.run_random_erasing(norm, np.random.RandomState(4)),
                                  ref_aug.run_random_erasing(norm, np.random.RandomState(4)))


def test_a_missing_decoder_raises(trees, monkeypatch):
    """Without cv2 the loaders stop at the first frame they must read; nothing falls back."""
    from vpho_tpu_torch.data import codec

    port, _ = _datasets(trees, False, True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        codec.decoder()
    with pytest.raises(ImportError, match="OpenCV"):
        port[0]
