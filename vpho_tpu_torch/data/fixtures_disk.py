"""Mini DexYCB and HO3D trees on disk (counterpart of ``vpho_tpu/data/fixtures_disk.py`` and of
the ``mini_ho3d`` fixture of ``tests/test_ho3d.py``).

Real-shaped trees with geometrically consistent annotations (projected synthetic-MANO joints,
object poses), so that the whole per-item pipeline runs without real assets: decoding, the
crop, augmentation, the FK corrections, the flip, heatmaps and contact labels.  The frames
are 640x480 by default, with photograph-like content (smooth gradients and noise); DexYCB's
are JPEG, HO3D's PNG, as the real datasets ship them.  Given the same arguments, the frames
are the JAX package's byte for byte and the annotations agree with its to float rounding
(their joints come from the port's FK).
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

from . import dexycb as D
from .codec import imwrite_rgb, require_cv2


def _frame(rng, H: int, W: int, i: int, noise: float, phase: bool) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    j = i if phase else 0
    return np.stack([127 + 80 * np.sin(xx / 37 + j) + noise * rng.randn(H, W),
                     127 + 80 * np.cos(yy / 53 + j) + noise * rng.randn(H, W),
                     127 + 60 * np.sin((xx + yy) / 71) + noise * rng.randn(H, W)], axis=-1)


def build_mini_dexycb(root: str, n: int = 3, seed: int = 0, sides=None,
                      image_size=(640, 480)) -> str:
    """An n-frame DexYCB s0 tree under ``root`` (JPEG frames, ``dex_ycb_s0_{train,test}_data
    .json``, the same frames in both splits); returns ``root``.  ``sides``: 'right' / 'left'
    per frame, by default every third frame left."""
    rng = np.random.RandomState(seed)
    W, H = image_size
    fx = fy = 600.0
    ppx, ppy = W / 2.0, H / 2.0
    if sides is None:
        sides = ["left" if i % 3 == 2 else "right" for i in range(n)]
    model = D.host_mano("right")
    K = np.array([[fx, 0, ppx], [0, fy, ppy], [0, 0, 1]])
    samples = {}
    for i in range(n):
        side = sides[i]
        pca = rng.randn(45) * 0.1
        beta = rng.randn(10) * 0.3
        global_rot = rng.randn(3) * 0.2
        transl = np.array([0.04 * rng.rand() - 0.02, 0.01, 0.55])
        aa_flat = pca @ model.hands_components + model.hands_mean
        _, jt3d = D.get_hand_vert(aa_flat, beta, global_rot, transl, side == "right")
        jt2d = jt3d @ K.T
        jt2d = jt2d[:, :2] / jt2d[:, 2:]
        obj_rt = np.concatenate([np.eye(3), transl[:, None] + 0.02], axis=1)
        seq = f"20200820-subject-0{i % 9 + 1}/20200820_1355{i:02d}/836212060125"
        color_file = f"{seq}/color_{i:06d}.jpg"
        os.makedirs(os.path.join(root, os.path.dirname(color_file)), exist_ok=True)
        img = np.clip(_frame(rng, H, W, i, 20.0, True), 0, 255).astype(np.uint8)
        imwrite_rgb(os.path.join(root, color_file), img[..., ::-1])
        samples[f"s{i}"] = {
            "color_file": color_file,
            "intrinsics": {"fx": fx, "fy": fy, "ppx": ppx, "ppy": ppy},
            "ycb_ids": [1 + i % 21],
            "ycb_grasp_ind": 0,
            "mano_side": side,
            "mano_betas": beta.tolist(),
            "joint_3d": [jt3d.tolist()],
            "joint_2d": [jt2d.tolist()],
            "pose_y": [obj_rt.tolist()],
            "pose_m": [np.concatenate([global_rot, pca, transl]).tolist()],
        }
    for split in ("train", "test"):
        with open(os.path.join(root, f"dex_ycb_s0_{split}_data.json"), "w") as f:
            json.dump(samples, f)
    return root


GL = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)     # OpenGL <-> OpenCV


def _write_ho3d_frame(root: str, split: str, seq: str, frame: str, meta: dict, rng,
                      image_size) -> None:
    W, H = image_size
    for sub in ("meta", "rgb"):
        os.makedirs(os.path.join(root, split, seq, sub), exist_ok=True)
    with open(os.path.join(root, split, seq, "meta", f"{frame}.pkl"), "wb") as f:
        pickle.dump(meta, f)
    # PNG is lossless: blur the noise to a photograph's spectrum, as JPEG would
    img = require_cv2().GaussianBlur(
        np.clip(_frame(rng, H, W, 0, 15.0, False), 0, 255).astype(np.float32), (3, 3), 0.8)
    img = np.clip(img, 0, 255).astype(np.uint8)
    imwrite_rgb(os.path.join(root, split, seq, "rgb", f"{frame}.png"), img[..., ::-1])


def build_mini_ho3d(root: str, n_train: int = 11, n_eval: int = 2, seed: int = 7,
                    image_size=(640, 480)) -> dict:
    """An HO3D v2 tree under ``root``: ``n_train`` frames of ``train/ABF10`` with full
    annotations in the OpenGL frame, ``n_eval`` of ``evaluation/SM1`` with only the wrist,
    the hand box and the object pose, and ``evaluation.txt`` listing the evaluation frames in
    reverse order (the loader must follow the file, not sort).  Returns the ground truth in
    the OpenCV frame: {"train": [{jt_cv, R_cv, t_cv}], "eval": [{root_cv, R_cv, t_cv}]}."""
    rng = np.random.RandomState(seed)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    model = D.host_mano("right")

    def geometry(i):
        aa_flat = rng.randn(45) * 0.1 + model.hands_mean
        beta = rng.randn(10) * 0.3
        grot = rng.randn(3) * 0.2
        transl = np.array([0.01 * i - 0.02, 0.01, 0.55])
        _, jt_cv = D.get_hand_vert(aa_flat, beta, grot, transl, True)
        # a generic object rotation: GL @ R_cv keeps away from the axis-angle singularity
        R_cv = D._aa_to_mat(np.array([0.1, 0.4, -0.2]))
        return aa_flat, beta, grot, transl, jt_cv, R_cv, transl + np.array([0.03, 0.0, 0.02])

    gt = {"train": [], "eval": []}
    for i in range(n_train):
        aa_flat, beta, grot, transl, jt_cv, R_cv, t_cv = geometry(i)
        meta = {"handPose": np.concatenate([D._mat_to_aa(GL @ D._aa_to_mat(grot)),
                                            aa_flat]).astype(np.float32),
                "handBeta": beta.astype(np.float32),
                "handJoints3D": (jt_cv @ GL).astype(np.float32),
                "handTrans": (GL @ transl).astype(np.float32),
                "objName": "025_mug",
                "objRot": D._mat_to_aa(GL @ R_cv).reshape(3, 1),
                "objTrans": (GL @ t_cv).astype(np.float32),
                "camMat": K}
        _write_ho3d_frame(root, "train", "ABF10", f"{i:04d}", meta, rng, image_size)
        gt["train"].append({"jt_cv": jt_cv, "R_cv": R_cv, "t_cv": t_cv})
    for i in range(n_eval):
        aa_flat, beta, grot, transl, jt_cv, R_cv, t_cv = geometry(i + 3)
        jt2d = jt_cv @ K.T
        jt2d = jt2d[:, :2] / jt2d[:, 2:]
        x1, y1 = jt2d.min(0) - 5
        x2, y2 = jt2d.max(0) + 5
        meta = {"handJoints3D": (GL @ jt_cv[0]).astype(np.float32),
                "handBoundingBox": np.array([x1, y1, x2, y2], np.float32),
                "objName": "025_mug",
                "objRot": D._mat_to_aa(GL @ R_cv).reshape(3, 1),
                "objTrans": (GL @ t_cv).astype(np.float32),
                "camMat": K}
        _write_ho3d_frame(root, "evaluation", "SM1", f"{i:04d}", meta, rng, image_size)
        gt["eval"].append({"root_cv": jt_cv[0], "R_cv": R_cv, "t_cv": t_cv})
    with open(os.path.join(root, "evaluation.txt"), "w") as f:
        for i in reversed(range(n_eval)):
            f.write(f"SM1/{i:04d}\n")
    return gt
