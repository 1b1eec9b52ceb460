"""Synthetic, geometrically consistent batches (counterpart of
``vpho_tpu/data/fixtures.py::make_batch``), with the key contract of the live dataset.

Draws come from ``numpy.random.RandomState(seed)``: a MANO pose and shape -> FK vertices and
joints, a camera, projected joints -> hand bboxes and heatmaps; an object pose near the wrist
-> projected keypoints -> object bboxes and heatmaps; random normalized RGB and anchor forces.
Every sample is a right hand and grasped, as in the JAX fixture.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import heads
from ..models.mano import hand_verts_meters
from ..ops.heatmap import adaptive_bbox_heatmap, square_bbox_heatmap
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


def _paint_blobs(pt2d: np.ndarray, size: int, sigma: float) -> np.ndarray:
    """Sum of Gaussians of (B, N, 2) points on a (B, size, size) map."""
    ax = np.arange(size, dtype=np.float32)
    gx = np.exp(-((ax[None, None] - pt2d[..., 0:1]) ** 2) / (2 * sigma ** 2))
    gy = np.exp(-((ax[None, None] - pt2d[..., 1:2]) ** 2) / (2 * sigma ** 2))
    return np.einsum("bny,bnx->byx", gy, gx)


def make_batch(ctx, seed: int = 0, batch_size: int = 2, patch_size: int = 128,
               heatmap_size: int = 64, signal: bool = False) -> Dict[str, torch.Tensor]:
    """One synthetic batch on ``ctx.device``.  ``signal`` paints the projected hand joints
    (channel 0) and object keypoints (channel 1) into the image as Gaussian blobs, so that an
    image-to-pose mapping exists."""
    return to_device(make_arrays(ctx, seed, batch_size, patch_size, heatmap_size, signal),
                     ctx.device)


def host_context(ctx):
    """``ctx`` with its MANO and object constants on the host (itself when they are there): a
    stream built on it in a loader thread copies nothing from the device, which could meet a
    CUDA graph's warm-up or capture, under the process-wide ``set_sync_debug_mode("error")``,
    in the main thread."""
    on_host = lambda nt: type(nt)(*[t.cpu() if isinstance(t, torch.Tensor) else t for t in nt])
    return ctx._replace(mano=on_host(ctx.mano), registry=on_host(ctx.registry))


def make_arrays(ctx, seed: int = 0, batch_size: int = 2, patch_size: int = 128,
                heatmap_size: int = 64, signal: bool = False) -> Dict[str, np.ndarray]:
    """:func:`make_batch` as host numpy arrays."""
    rng = np.random.RandomState(seed)
    B, P = batch_size, patch_size
    host = host_context(ctx)
    mano_cpu, registry_cpu = host.mano, host.registry

    gt_pose = (rng.randn(B, 48) * 0.2).astype(np.float32)
    gt_shape = (rng.randn(B, 10) * 0.3).astype(np.float32)
    vert, joint = (v.numpy() for v in hand_verts_meters(
        mano_cpu, torch.from_numpy(gt_pose), torch.from_numpy(gt_shape)))
    root = np.concatenate([rng.randn(B, 2) * 0.02, 0.5 + rng.rand(B, 1) * 0.2],
                          axis=-1).astype(np.float32)
    f = P * 2.2
    K = np.tile(np.array([[f, 0, P / 2], [0, f, P / 2], [0, 0, 1.0]], np.float32), (B, 1, 1))
    jt2d = _project(joint + root[:, None], K)
    bbox_hand = _bbox_from_pts(jt2d, 1.2, P)

    obj_ids = rng.randint(0, 21, size=B)
    obj_rot = T.matrix_to_rotation_6d(T.axis_angle_to_matrix(
        torch.from_numpy(rng.randn(B, 3).astype(np.float32))))
    # the object translation is wrist-relative; its camera frame adds the root
    obj_trans = torch.from_numpy((rng.randn(B, 3) * 0.03).astype(np.float32))
    gt_obj = torch.cat([obj_rot, obj_trans], dim=-1)
    pose_cam = torch.cat([obj_rot, obj_trans + torch.from_numpy(root)], dim=-1)
    ids = torch.from_numpy(obj_ids)
    kpt2d = _project(heads.object_transform(registry_cpu, pose_cam, ids, "keypoint").numpy(), K)
    bbox_obj = _bbox_from_pts(kpt2d, 1.2, P)
    obj_com = heads.object_transform(registry_cpu, pose_cam, ids, "CoM").numpy()

    rgb = (rng.randn(B, P, P, 3) * 0.5).astype(np.float32)
    if signal:
        sigma = P / 64.0
        rgb = rgb * 0.1
        rgb[..., 0] += 2.0 * _paint_blobs(jt2d, P, sigma)
        rgb[..., 1] += 2.0 * _paint_blobs(kpt2d, P, sigma)
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
        "obj_name": obj_ids.astype(np.int32),        # integer ids, as in the JAX fixture
        "gt_mano": np.concatenate([gt_pose, gt_shape], axis=-1),
        "gt_obj": gt_obj.numpy(),
        "gt_hand_vert_flip": vert,
        "gt_hand_jt3d_flip": joint,
        "hm_hand": adaptive_bbox_heatmap(th(jt2d), th(bbox_hand), heatmap_size, 2.0).numpy(),
        "hm_obj": square_bbox_heatmap(th(kpt2d), th(bbox_obj), heatmap_size, 2.0).numpy(),
        "force_local": (rng.randn(B, 32, 3) * 0.1).astype(np.float32),
    }
    return {k: np.asarray(v) for k, v in arrays.items()}


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (floats as float32)."""
    out = {}
    for k, v in arrays.items():
        v = np.array(v)
        out[k] = torch.as_tensor(v.astype(np.float32) if v.dtype.kind == "f" else v,
                                 device=device)
    return out
