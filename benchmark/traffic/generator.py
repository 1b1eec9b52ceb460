"""The benchmark's one traffic generator: seeded synthetic DexYCB-like batches.

A frozen copy of the port's fixture (``vpho_tpu_torch/data/fixtures.py::make_arrays``) and of
the eval keys the runner attaches (``engine/runner.py::_augment_eval_keys``), on the
reference's MANO FK, heatmaps and transforms.  Draws come from ``numpy.random.RandomState``:
a MANO pose and shape -> FK vertices and joints, a camera, projected joints -> hand boxes and
heatmaps; an object pose near the wrist -> projected keypoints -> object boxes and heatmaps;
random normalized RGB and anchor forces.  Every sample is a right hand and grasped.

A mix (``traffic/mixes/<name>.json``) fixes the sizes: ``batch_size``, ``pool`` (batches made
in set-up and cycled through the window), ``patch_size``, ``heatmap_size`` and whether the
batches carry the eval keys.  A run's ``--seed`` picks the draws, never the sizes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from ..reference.vpho_ref.models import heads
from ..reference.vpho_ref.models.mano import hand_verts_meters
from ..reference.vpho_ref.ops.heatmap import adaptive_bbox_heatmap, square_bbox_heatmap
from ..reference.vpho_ref.utils import transforms as T

MIXES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mixes")


def load_mix(name: str) -> Dict:
    with open(os.path.join(MIXES, f"{name}.json")) as f:
        return json.load(f)


def batch_seed(seed: int, k: int) -> int:
    """The RandomState seed of a run's k-th batch (any run seed, 32 bits out)."""
    return (int(seed) * 1000003 + 7919 * int(k) + 17) % (2 ** 32)


def _bbox_from_pts(pt2d: np.ndarray, scale: float, size: int) -> np.ndarray:
    mn, mx = pt2d.min(axis=-2), pt2d.max(axis=-2)
    c = (mn + mx) / 2
    half = (mx - mn) / 2 * scale + 2.0
    return np.clip(np.concatenate([c - half, c + half], axis=-1), 0.0, size - 1.0)


def _rectangularize(bbox: np.ndarray, size: int) -> np.ndarray:
    c = (bbox[..., :2] + bbox[..., 2:]) / 2
    half = np.max(bbox[..., 2:] - bbox[..., :2], axis=-1, keepdims=True) / 2
    return np.clip(np.concatenate([c - half, c + half], axis=-1), 0.0, size - 1.0)


def _project(pt3d: np.ndarray, K: np.ndarray) -> np.ndarray:
    uvw = np.einsum("bni,bji->bnj", pt3d, K)
    return uvw[..., :2] / uvw[..., 2:]


def make_arrays(mano, registry, seed: int, batch_size: int, patch_size: int,
                heatmap_size: int) -> Dict[str, np.ndarray]:
    """One batch as host numpy arrays; ``mano`` and ``registry`` hold CPU tensors."""
    rng = np.random.RandomState(seed)
    B, P = batch_size, patch_size

    gt_pose = (rng.randn(B, 48) * 0.2).astype(np.float32)
    gt_shape = (rng.randn(B, 10) * 0.3).astype(np.float32)
    vert, joint = (v.numpy() for v in hand_verts_meters(
        mano, torch.from_numpy(gt_pose), torch.from_numpy(gt_shape)))
    root = np.concatenate([rng.randn(B, 2) * 0.02, 0.5 + rng.rand(B, 1) * 0.2],
                          axis=-1).astype(np.float32)
    f = P * 2.2
    K = np.tile(np.array([[f, 0, P / 2], [0, f, P / 2], [0, 0, 1.0]], np.float32), (B, 1, 1))
    jt2d = _project(joint + root[:, None], K)
    bbox_hand = _bbox_from_pts(jt2d, 1.2, P)

    obj_ids = rng.randint(0, 21, size=B)
    obj_rot = T.matrix_to_rotation_6d(T.axis_angle_to_matrix(
        torch.from_numpy(rng.randn(B, 3).astype(np.float32))))
    obj_trans = torch.from_numpy((rng.randn(B, 3) * 0.03).astype(np.float32))
    gt_obj = torch.cat([obj_rot, obj_trans], dim=-1)
    pose_cam = torch.cat([obj_rot, obj_trans + torch.from_numpy(root)], dim=-1)
    ids = torch.from_numpy(obj_ids)
    kpt2d = _project(heads.object_transform(registry, pose_cam, ids, "keypoint").numpy(), K)
    bbox_obj = _bbox_from_pts(kpt2d, 1.2, P)
    obj_com = heads.object_transform(registry, pose_cam, ids, "CoM").numpy()

    rgb = (rng.randn(B, P, P, 3) * 0.5).astype(np.float32)
    th = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    arrays = {
        "rgb": rgb,
        "bbox_hand": bbox_hand,
        "bbox_obj": bbox_obj,
        "bbox_hand_rect": _rectangularize(bbox_hand, P),
        "bbox_obj_rect": _rectangularize(bbox_obj, P),
        "is_right": np.ones((B,), bool),
        "is_ho3d": np.zeros((B,), bool),
        "is_grasped": np.ones((B,), np.float32),
        "root_joint": root,
        "root_joint_flip": root,
        "cam_intr_crop": K,
        "cam_intr_crop_flip": K,
        "gravity": np.tile(np.array([0.0, 1.0, 0.0], np.float32), (B, 1, 1)),
        "obj_CoM": obj_com,
        "obj_id": obj_ids.astype(np.int32),
        "obj_name": obj_ids.astype(np.int32),
        "gt_mano": np.concatenate([gt_pose, gt_shape], axis=-1),
        "gt_obj": gt_obj.numpy(),
        "gt_hand_vert_flip": vert,
        "gt_hand_jt3d_flip": joint,
        "hm_hand": adaptive_bbox_heatmap(th(jt2d), th(bbox_hand), heatmap_size, 2.0).numpy(),
        "hm_obj": square_bbox_heatmap(th(kpt2d), th(bbox_obj), heatmap_size, 2.0).numpy(),
        "force_local": (rng.randn(B, 32, 3) * 0.1).astype(np.float32),
    }
    return {k: np.asarray(v) for k, v in arrays.items()}


def with_eval_keys(batch: Dict[str, np.ndarray], first_index: int) -> Dict[str, np.ndarray]:
    """The camera-frame ground truth the eval loop reads (gt_joint, gt_hand_vert, gt_obj_rt,
    cam_intr), and the ``_index`` / ``_valid`` columns; every sample is a right hand, so no
    flip applies."""
    root = batch["root_joint"][:, None]
    rt = T.obj_9d_to_mat(torch.from_numpy(batch["gt_obj"])).numpy()
    out = dict(batch)
    out["gt_joint"] = batch["gt_hand_jt3d_flip"] + root
    out["gt_hand_vert"] = batch["gt_hand_vert_flip"] + root
    out["gt_obj_rt"] = np.concatenate([rt[..., :3], rt[..., 3:] + root.transpose(0, 2, 1)], -1)
    out["cam_intr"] = batch["cam_intr_crop"]
    n = len(batch["rgb"])
    out["_index"] = np.arange(first_index, first_index + n)
    out["_valid"] = np.ones((n,), bool)
    return out


def make_pool(mix: Dict, seed: int, mano, registry) -> List[Dict[str, np.ndarray]]:
    """The run's ``mix["pool"]`` batches, each of ``mix["batch_size"]`` samples."""
    pool = []
    for k in range(mix["pool"]):
        b = make_arrays(mano, registry, batch_seed(seed, k), mix["batch_size"],
                        mix["patch_size"], mix["heatmap_size"])
        if mix["eval_keys"]:
            b = with_eval_keys(b, k * mix["batch_size"])
        pool.append(b)
    return pool
