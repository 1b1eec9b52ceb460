"""Visualization dumps in the Batch3D pkl convention (counterpart of
``vpho_tpu/engine/viz.py``).

Point-cloud dicts whose keys carry a ``_#RRGGBB`` colour suffix, pickled under ``<run>/viz/``
(hand, object, force and mesh-force dumps), plus heatmap and segmentation overlay JPGs.  The
JPG writers import cv2 when they run; ``jpg_writer_available`` says whether they can.  All
inputs are host (numpy) arrays of one sample.
"""
from __future__ import annotations

import importlib.util
import os
import pickle
from typing import Dict

import numpy as np

from ..models.ycb import YCBRegistry

# ImageNet normalization of the input crops
IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def jpg_writer_available() -> bool:
    """True when cv2, which the JPG writers need, is installed."""
    return importlib.util.find_spec("cv2") is not None


def _rand_color_hex(rng: np.random.RandomState, exclude=(0, 255, 0)) -> str:
    while True:
        c = rng.randint(0, 256, 3)
        if not np.array_equal(c, np.asarray(exclude)):
            return f"#{c[0]:02X}{c[1]:02X}{c[2]:02X}"


def _dump(save_dir: str, name: str, data: Dict[str, np.ndarray]):
    path = os.path.join(save_dir, "viz", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(v) if not isinstance(v, (str, type(None))) else v
                     for k, v in data.items()}, f)
    return path


def save_viz_hand(save_dir: str, idx: int, *, gt_vert, gt_obj_vert, pd_vert_reg,
                  pd_vert_diff, pd_vert_agg, rgb_path: str = "", max_hyp: int = 20,
                  seed: int = 0):
    """Hand multi-hypothesis dump (train_diff_hand_obj.py:637-665)."""
    rng = np.random.RandomState(seed)
    reg_dt = {
        "rgb_path": rgb_path,
        "gt_hand_#000000": gt_vert,
        "gt_obj_#00FF00": gt_obj_vert,
        "pd_vert_reg_#00FF00": pd_vert_reg,
        "pd_vert_diff_agg_#FF0000": pd_vert_agg,
    }
    _dump(save_dir, f"{idx}_hand_reg_&_diff_mean.pkl", reg_dt)
    multi = dict(reg_dt)
    for s in range(min(len(pd_vert_diff), max_hyp)):
        multi[f"hand_diff_vert_{s}_{_rand_color_hex(rng)}"] = pd_vert_diff[s]
    return _dump(save_dir, f"{idx}_hand_multihyperthesis.pkl", multi)


def save_viz_obj(save_dir: str, idx: int, registry: YCBRegistry, obj_id: int, *,
                 gt_rt, pd_rt_cands, pd_rt_agg, gt_hand, rgb_path: str = "",
                 max_hyp: int = 20, seed: int = 0):
    """Object multi-hypothesis dump (train_diff_hand_obj.py:604-635)."""
    rng = np.random.RandomState(seed)
    verts = registry.verts_sampled[obj_id].cpu().numpy()

    def tf(rt):
        return verts @ np.asarray(rt)[:3, :3].T + np.asarray(rt)[:3, 3]

    dt = {
        "rgb_path": rgb_path,
        "obj_name": registry.names[obj_id],
        "gt_hand_#000000": gt_hand,
        "obj_gt_vert_#00FF00": tf(gt_rt),
        "obj_pd_vert_mean_#FF0000": tf(pd_rt_agg),
    }
    for s in range(min(len(pd_rt_cands), max_hyp)):
        dt[f"obj_diff_vert_{s}_{_rand_color_hex(rng)}"] = tf(pd_rt_cands[s])
    return _dump(save_dir, f"{idx}_obj_multihyperthesis.pkl", dt)


def save_viz_force(save_dir: str, idx: int, *, vert, force_point, force_global,
                   gravity, com, obj_mesh, skeleton=None):
    """Force visualization (force_optimization.py:209-232)."""
    force = np.stack([np.asarray(force_point),
                      np.asarray(force_point) + np.asarray(force_global) * 0.3], axis=1)
    grav = np.concatenate([np.asarray(com),
                           np.asarray(com) + np.asarray(gravity) * 0.3], axis=0)[None]
    dt = {
        "vert_#00FF00": vert,
        "force_#FF0000": force,
        "gravity_#0000FF": grav,
        "obj_mesh_#000000": obj_mesh,
    }
    if skeleton is not None:
        dt["skeleton_#00FF00"] = skeleton
    return _dump(save_dir, f"{idx}_optimized_force.pkl", dt)


def save_viz_mesh_force(save_dir: str, idx: int, *, obj_verts, obj_faces,
                        gt_rt, pd_rt, root_joint, root_joint_flip,
                        gt_hand_vert, pd_hand_vert, hand_faces,
                        gt_force_local, pd_force_local, anchor_tables,
                        gravity, com, K, is_right=True, rgb_path: str = ""):
    """Full-mesh force dump (train_diff_hand_obj.py:775-856).

    Reference parity notes: writes ``{idx}_force.pkl`` with ``gt_mesh`` /
    ``pd_mesh`` / ``*_hand_mesh`` entries as ``{'vertex', 'face'}`` dicts,
    force/gravity line segments, and the camera intrinsics ``K`` — the
    camera-projectable variant of :func:`save_viz_force` (the reference
    defines it but never calls it; kept because it is the only writer
    that carries mesh topology + intrinsics for render-based inspection).

    All inputs are single-sample host arrays.  Verts are root-relative in
    the flipped (right-hand) frame, as the aggregation emits them; the
    reference un-flips x for left hands before dumping (:802-808) and adds
    the flipped root back for camera-frame placement (:826-850).  Forces
    arrive as LOCAL anchor-frame vectors and are converted to global
    points/directions AFTER the flip, from the dumped verts themselves
    (``from_local_to_global`` on post-flip pd verts / unflipped gt verts,
    :811-812) — so the arrows stay attached to the meshes they annotate.
    """
    from ..models.anchor import force_local_to_global_np

    obj_verts = np.asarray(obj_verts)
    gt_rt = np.asarray(gt_rt)
    pd_rt = np.asarray(pd_rt)
    root = np.asarray(root_joint)
    gt_obj_vert = obj_verts @ gt_rt[:3, :3].T + gt_rt[:3, 3] - root
    pd_obj_vert = obj_verts @ pd_rt[:3, :3].T + pd_rt[:3, 3] - root
    com = np.asarray(com)
    gt_com = com @ gt_rt[:3, :3].T + gt_rt[:3, 3] - root
    pd_com = com @ pd_rt[:3, :3].T + pd_rt[:3, 3] - root
    gt_hand = np.asarray(gt_hand_vert)  # NOT flipped (reference :803-810)
    pd_hand = np.asarray(pd_hand_vert) - root
    gravity = np.array(gravity, copy=True)

    if not is_right:
        for a in (gt_obj_vert, pd_obj_vert, pd_hand, gravity):
            a[..., 0] = -a[..., 0]
        gt_com = gt_com * np.array([-1.0, 1, 1])
        pd_com = pd_com * np.array([-1.0, 1, 1])

    gt_force_point, gt_force_global = force_local_to_global_np(
        anchor_tables, gt_force_local, gt_hand)
    pd_force_point, pd_force_global = force_local_to_global_np(
        anchor_tables, pd_force_local, pd_hand)
    gt_force = np.stack([gt_force_point,
                         gt_force_point + gt_force_global * 0.1], axis=1)
    pd_force = np.stack([pd_force_point,
                         pd_force_point + pd_force_global * 0.1], axis=1)
    gt_grav = np.stack([gt_com[None], gt_com[None] + gravity * 0.1], axis=1)
    pd_grav = np.stack([pd_com[None], pd_com[None] + gravity * 0.1], axis=1)

    rf = np.asarray(root_joint_flip)
    dt = {
        "gt_mesh": {"vertex": gt_obj_vert + rf, "face": np.asarray(obj_faces)},
        "pd_mesh": {"vertex": pd_obj_vert + rf, "face": np.asarray(obj_faces)},
        "gt_force_line_#00FF00": gt_force + rf,
        "pd_force_line_#FF0000": pd_force + rf,
        "gt_hand_mesh": {"vertex": gt_hand + rf, "face": np.asarray(hand_faces)},
        "pd_hand_mesh": {"vertex": pd_hand + rf, "face": np.asarray(hand_faces)},
        "gt_gravity_line_#00FF00": gt_grav + rf,
        "pd_gravity_line_#FF0000": pd_grav + rf,
        "K": np.asarray(K),
    }
    path = os.path.join(save_dir, "viz", f"{idx}_force.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dt, f)
    if rgb_path and os.path.exists(rgb_path):
        import shutil

        shutil.copy(rgb_path, os.path.join(save_dir, "viz", f"{idx}_rgb.jpg"))
    return path


def _denorm_crop(rgb_norm, bbox):
    """Undo imagenet normalization and crop to an int xyxy bbox.

    Returns a uint8 RGB crop, or None for a degenerate bbox.  Shared by the
    heatmap and segmentation writers so the denorm/clamping conventions
    cannot drift between them.
    """
    rgb = ((np.asarray(rgb_norm) * IMG_STD + IMG_MEAN) * 255).clip(0, 255).astype(np.uint8)
    b = np.asarray(bbox).astype(np.int64)
    crop = rgb[max(b[1], 0):b[3], max(b[0], 0):b[2]]
    return None if crop.size == 0 else crop


def save_viz_segmentation(save_dir: str, idx: int, *, rgb_norm, bbox_obj,
                          pd_obj_segm, gt_obj_segm):
    """Object segmentation side-by-side JPG (train_diff_hand_obj.py:701-718).

    The reference calls this only when the model emits ``obj_segm``
    (:310-314) — the live vpho_net never does (HeadSegm is defined but not
    instantiated), so like the reference this writer is reachable but
    normally dormant.  Layout matches: [rgb obj crop | gt segm | pd segm]
    concatenated horizontally, colormapped like depth_to_rgb.

    rgb_norm: (H, W, 3) normalized image; bbox_obj: (4,) xyxy;
    pd/gt_obj_segm: (h, w) float maps (the gt map is resampled to the
    prediction's resolution if they differ).
    """
    import cv2

    crop = _denorm_crop(rgb_norm, bbox_obj)
    if crop is None:
        return None
    pd = np.atleast_2d(np.asarray(pd_obj_segm, dtype=np.float32))
    gt = np.atleast_2d(np.asarray(gt_obj_segm, dtype=np.float32))
    if gt.shape != pd.shape:
        gt = cv2.resize(gt, (pd.shape[1], pd.shape[0]))

    def colorize(m):
        m8 = (np.clip(m, 0.0, 1.0) * 255).astype(np.uint8)
        return cv2.applyColorMap(m8, cv2.COLORMAP_JET)[..., ::-1]

    crop = cv2.resize(crop, (pd.shape[1], pd.shape[0]))
    grid = np.concatenate([crop, colorize(gt), colorize(pd)], axis=1)
    path = os.path.join(save_dir, "viz", f"{idx}_gt&pd_obj_segmentation.jpg")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, grid[..., ::-1])
    return path


def make_heatmap_overlay(rgb_crop: np.ndarray, heatmaps: np.ndarray) -> np.ndarray:
    """Grid of per-joint heatmap overlays (viz_fn.make_heatmaps analogue).

    rgb_crop: (H, W, 3) uint8; heatmaps: (J, H, W) -> (H, (J+1)*W, 3)."""
    import cv2

    H, W = rgb_crop.shape[:2]
    panels = [rgb_crop]
    for j in range(heatmaps.shape[0]):
        hm = np.clip(heatmaps[j], 0, 1)
        hm8 = (hm * 255).astype(np.uint8)
        cmap = cv2.applyColorMap(hm8, cv2.COLORMAP_JET)[..., ::-1]
        overlay = (0.6 * rgb_crop + 0.4 * cmap).astype(np.uint8)
        panels.append(overlay)
    return np.concatenate(panels, axis=1)


def save_viz_heatmap(save_dir: str, idx: int, *, rgb_norm, bbox_hand, bbox_obj,
                     pd_hm_hand, gt_hm_hand, pd_hm_obj, gt_hm_obj):
    """Heatmap JPG grids (train_diff_hand_obj.py:667-703)."""
    import cv2

    out_paths = []
    for tag, bbox, pd_hm, gt_hm in (
        ("hand", bbox_hand, pd_hm_hand, gt_hm_hand),
        ("obj", bbox_obj, pd_hm_obj, gt_hm_obj),
    ):
        crop = _denorm_crop(rgb_norm, bbox)
        if crop is None:
            continue
        size = np.asarray(pd_hm).shape[-1]
        crop = cv2.resize(crop, (size, size))
        gt_row = make_heatmap_overlay(crop, np.asarray(gt_hm))
        pd_row = make_heatmap_overlay(crop, np.asarray(pd_hm))
        grid = np.concatenate([gt_row, pd_row], axis=0)
        path = os.path.join(save_dir, "viz", f"{idx}_gt&pd_{tag}_heatmap.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, grid[..., ::-1])
        out_paths.append(path)
    return out_paths
