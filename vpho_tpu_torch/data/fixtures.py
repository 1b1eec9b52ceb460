"""Synthetic, geometrically consistent predict batches (counterpart of
``vpho_tpu/data/fixtures.py::make_batch``, limited to the keys the predict path reads).

Draws come from ``numpy.random.RandomState(seed)``: a MANO pose and shape -> FK joints, a
camera, projected joints -> hand bboxes; an object pose near the wrist -> projected keypoints
-> object bboxes; random normalized RGB.  Every sample is a right hand and grasped, as in the
JAX fixture.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import heads
from ..models.mano import hand_joints_meters
from ..utils import transforms as T


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


def make_batch(ctx, seed: int = 0, batch_size: int = 2, patch_size: int = 128
               ) -> Dict[str, torch.Tensor]:
    """One synthetic batch on ``ctx.device``."""
    rng = np.random.RandomState(seed)
    B, P = batch_size, patch_size
    cpu = torch.device("cpu")
    mano_cpu = type(ctx.mano)(*[t.to(cpu) if isinstance(t, torch.Tensor) else t
                                for t in ctx.mano])
    registry_cpu = type(ctx.registry)(*[t.to(cpu) if isinstance(t, torch.Tensor) else t
                                        for t in ctx.registry])

    gt_pose = (rng.randn(B, 48) * 0.2).astype(np.float32)
    gt_shape = (rng.randn(B, 10) * 0.3).astype(np.float32)
    joint = hand_joints_meters(mano_cpu, torch.from_numpy(gt_pose),
                               torch.from_numpy(gt_shape)).numpy()
    root = np.concatenate([rng.randn(B, 2) * 0.02, 0.5 + rng.rand(B, 1) * 0.2],
                          axis=-1).astype(np.float32)
    f = P * 2.2
    K = np.tile(np.array([[f, 0, P / 2], [0, f, P / 2], [0, 0, 1.0]], np.float32), (B, 1, 1))
    jt2d = _project(joint + root[:, None], K)
    bbox_hand = _bbox_from_pts(jt2d, 1.2, P)

    obj_ids = rng.randint(0, 21, size=B)
    obj_rot = T.matrix_to_rotation_6d(T.axis_angle_to_matrix(
        torch.from_numpy(rng.randn(B, 3).astype(np.float32))))
    obj_trans = torch.from_numpy((rng.randn(B, 3) * 0.03 + root).astype(np.float32))
    pose_cam = torch.cat([obj_rot, obj_trans], dim=-1)
    ids = torch.from_numpy(obj_ids)
    kpt2d = _project(heads.object_transform(registry_cpu, pose_cam, ids, "keypoint").numpy(), K)
    bbox_obj = _bbox_from_pts(kpt2d, 1.2, P)
    obj_com = heads.object_transform(registry_cpu, pose_cam, ids, "CoM").numpy()

    arrays = {
        "rgb": (rng.randn(B, P, P, 3) * 0.5).astype(np.float32),
        "bbox_hand": bbox_hand,
        "bbox_obj": bbox_obj,
        "bbox_hand_rect": _rectangularize(bbox_hand, P),
        "bbox_obj_rect": _rectangularize(bbox_obj, P),
        "is_right": np.ones((B,), bool),
        "is_grasped": np.ones((B,), np.float32),
        "root_joint": root,
        "root_joint_flip": root,
        "cam_intr_crop_flip": K,
        "gravity": np.tile(np.array([0.0, 1.0, 0.0], np.float32), (B, 1, 1)),
        "obj_CoM": obj_com,
        "obj_id": obj_ids.astype(np.int32),
    }
    return to_device(arrays, ctx.device)


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (floats as float32)."""
    out = {}
    for k, v in arrays.items():
        v = np.array(v)
        out[k] = torch.as_tensor(v.astype(np.float32) if v.dtype.kind == "f" else v,
                                 device=device)
    return out
