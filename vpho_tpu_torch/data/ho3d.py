"""HO3D v2 loader (counterpart of ``vpho_tpu/data/ho3d.py``): train items and the GT-less
evaluation split, and the codalab dump.  Items equal the JAX package's (per-item
``np.random.RandomState((index * 7919 + 3) % 2**31)``, the same arithmetic).  HO3D against
DexYCB:
  * annotations live in per-frame ``meta/*.pkl`` files under
    ``train/<seq>/`` and ``evaluation/<seq>/``
  * poses/joints are in the OpenGL frame: converted with OPENGL_TO_OPENCV
    (transform_fn.py:156; ho3d3.py:116-127)
  * only right hands; joints use the manolayer order with HO3D tip
    definitions (``get_joint_aligned_with_ho3d``)
  * gravity / is-grasped come from published asset jsons when present, with
    graceful fallbacks otherwise
  * the evaluation split has no GT — results go to a codalab zip (engine
    ``infer`` path, train_diff_hand_obj.py:416-435)
"""
from __future__ import annotations

import json
import os
import pickle
import warnings
from typing import Dict, List

import numpy as np

from ..configs.config import Config
from ..models import anchor as anchor_lib
from ..models.ycb import YCB_CLASSES
from ..ops.heatmap import adaptive_bbox_heatmap_np, square_bbox_heatmap_np
from .augment import ImageAugmentor, normalize_rgb
from .codec import imread_rgb
from .dexycb import (DexYCBForceDataset, _aa_to_mat, _mat_to_aa, _mat_to_rot6d,
                     bbox_in_image, check_device_rotation, expand_bbox, get_hand_vert,
                     host_tables, pt2d_to_bbox, rectangularize, signed_contact_weights,
                     warp_host)

OPENGL_TO_OPENCV = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)

# HO3D object names map onto YCB ids directly
HO3D_OBJ_TO_YCB = {
    "003_cracker_box": 2, "004_sugar_box": 3, "006_mustard_bottle": 5,
    "010_potted_meat_can": 9, "011_banana": 10, "019_pitcher_base": 11,
    "021_bleach_cleanser": 12, "025_mug": 14, "035_power_drill": 15,
    "037_scissors": 17,
}
YCB_ID = {v: k for k, v in YCB_CLASSES.items()}


class HO3DForceDataset:
    """HO3D v2 splits mirror the reference's three dataset classes
    (ho3d3.py:421-494):

      * ``split='train'`` — HO3DDatasetForce_Train: full train split,
        ``get_train_item`` (GT hand + object, aug)
      * ``split='valid'`` — HO3DDatasetForce_Valid: every 10th train frame,
        ``get_train_item`` without aug (the with-GT sub-eval)
      * ``split='test'``  — HO3DDatasetForce_Test: the evaluation split in
        ``evaluation.txt`` order (codalab submission order!), no hand GT —
        ``get_eval_item`` (ho3d3.py:306-420)
    """

    def __init__(self, cfg: Config, data_dir: str, split: str = "train"):
        if split not in ("train", "valid", "test"):
            raise ValueError(f"HO3D split {split!r}: train, valid or test")
        self.cfg = cfg
        self.data_dir = data_dir
        self.split = split
        self.is_train = split == "train"
        self.host = host_tables(cfg.models_dir or None)
        self.mano_r, self.tables = self.host.mano_r, self.host.tables
        self.augmentor = ImageAugmentor.from_config(cfg)
        # --device_preprocess: train and valid items ship the decoded frame and the crop's
        # parameters, as DexYCB's.  The evaluation split stays in host mode: it has no hand
        # keypoints, and the device preprocess draws hm_hand from them.
        self.device_mode = check_device_rotation(cfg, self.is_train)
        self.index_ls = self._load_samples()
        self.dir2gravity = self._load_json("asset/ours/HO3D_v2/gravity_direction.json")
        self.is_grasped_dt = self._load_pkl("asset/ours/HO3D_v2/is_off_desk.pkl")
        self._warned = set()

    def _load_samples(self) -> List[str]:
        if self.split == "test":
            # evaluation.txt fixes the codalab frame order
            # (HO3DDatasetForce_Test.load_samples, ho3d3.py:468-479)
            txt = os.path.join(self.data_dir, "evaluation.txt")
            if os.path.exists(txt):
                index = []
                with open(txt) as f:
                    for line in f:
                        seq, frame = line.strip().split("/")
                        index.append(os.path.join(
                            self.data_dir, "evaluation", seq, "meta", frame))
                return index
            return self._list_split("evaluation")
        index = self._list_split("train")
        if self.split == "valid":
            index = index[::10]  # ho3d3.py:447
        return index

    def _list_split(self, split: str) -> List[str]:
        split_dir = os.path.join(self.data_dir, split)
        index = []
        if not os.path.isdir(split_dir):
            return index
        for subj in sorted(os.listdir(split_dir)):
            meta_dir = os.path.join(split_dir, subj, "meta")
            if os.path.isdir(meta_dir):
                for anno in sorted(os.listdir(meta_dir)):
                    index.append(os.path.join(meta_dir, os.path.splitext(anno)[0]))
        return index

    def get_path(self, index: int) -> str:
        return self.index_ls[index].replace("meta", "rgb") + ".png"

    @staticmethod
    def _load_json(path):
        return json.load(open(path)) if os.path.exists(path) else {}

    @staticmethod
    def _load_pkl(path):
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        return {}

    def get_gravity(self, sample_path: str) -> np.ndarray:
        key = sample_path.split("/meta")[0].split("/")[-1]
        if key in self.dir2gravity:
            return np.asarray(self.dir2gravity[key], np.float32).reshape(1, 3)
        return np.array([[0.0, 1.0, 0.0]], np.float32)

    def get_is_grasped(self, sample_path: str) -> float:
        parts = sample_path.split("/")
        key = f"{parts[-4]}/{parts[-3]}" if len(parts) >= 4 else ""
        if key in self.is_grasped_dt:
            try:
                return float(self.is_grasped_dt[key][int(parts[-1])])
            except (IndexError, ValueError):
                return 1.0
        return 1.0

    def get_contact(self, hand_vert: np.ndarray, obj_id: int,
                    obj_rt: np.ndarray) -> np.ndarray:
        """Per-hand-vertex contact vs the full object mesh — identical
        formula to the DexYCB path (the reference's HO3D items call the same
        shared ``get_hand_contact``, ho3d3.py:155-164 -> base.py:841-911)."""
        verts = self.host.verts_full[obj_id]
        obj_cam = verts @ obj_rt[:3, :3].T + obj_rt[:3, 3]
        lo, hi = getattr(self.cfg, "contact_normal_distance_thresh", (-0.01, 0.01))
        vthresh = getattr(self.cfg, "contact_vertical_distance_thresh", 0.005)
        return signed_contact_weights(hand_vert, self.mano_r.faces, obj_cam,
                                      lo=lo, hi=hi, tangential_thresh=vthresh)

    def get_force(self, rgb_path: str) -> np.ndarray:
        p = rgb_path.replace("HO3D_v2/", "HO3D_v2/cache/hand_force/") \
                    .replace(".png", ".pkl").replace("rgb/", "hand_force/")
        if os.path.exists(p):
            with open(p, "rb") as f:
                return np.asarray(pickle.load(f)["force_local"], np.float32)
        if "force" not in self._warned:
            warnings.warn("HO3D pseudo-force cache missing; zeros")
            self._warned.add("force")
        return np.zeros((32, 3), np.float32)

    def __len__(self):
        return len(self.index_ls)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.split == "test":
            return self.get_eval_item(index)
        return self.get_train_item(index)

    def get_train_item(self, index: int) -> Dict[str, np.ndarray]:
        sample_path = self.index_ls[index]
        with open(sample_path + ".pkl", "rb") as f:
            sample = pickle.load(f)
        rgb_path = sample_path.replace("meta", "rgb") + ".png"
        rgb = imread_rgb(rgb_path)
        K = np.asarray(sample["camMat"], np.float32)
        P = self.cfg.patch_size
        rng = np.random.RandomState((index * 7919 + 3) % 2**31)

        # hand: OpenGL -> OpenCV (ho3d3.py:116-127)
        pose_m = np.asarray(sample["handPose"], np.float32)
        beta = np.asarray(sample["handBeta"], np.float32)
        jt3d = np.asarray(sample["handJoints3D"], np.float32) @ OPENGL_TO_OPENCV.T
        global_rot = _mat_to_aa(OPENGL_TO_OPENCV @ _aa_to_mat(pose_m[:3]))
        transl = OPENGL_TO_OPENCV @ np.asarray(sample["handTrans"], np.float64).reshape(3)
        aa_flat = pose_m[3:]

        vert3d, _jt3d = get_hand_vert(aa_flat, beta, global_rot, transl, True)
        transl = transl + (jt3d[0] - _jt3d[0])
        vert3d, _jt3d = get_hand_vert(aa_flat, beta, global_rot, transl, True)
        jt2d = _jt3d @ K.T
        jt2d = jt2d[:, :2] / jt2d[:, 2:]

        # object
        obj_name = sample["objName"]
        obj_id = HO3D_OBJ_TO_YCB.get(obj_name, YCB_ID.get(obj_name, 1)) - 1
        obj_rot = OPENGL_TO_OPENCV @ _aa_to_mat(np.asarray(sample["objRot"], np.float64).reshape(3))
        obj_trans = OPENGL_TO_OPENCV @ np.asarray(sample["objTrans"], np.float64).reshape(3)
        obj_rt = np.concatenate([obj_rot, obj_trans[:, None]], axis=1).astype(np.float32)
        kpt3d = self.host.kpt3d[obj_id] @ obj_rt[:3, :3].T + obj_rt[:3, 3]
        kpt2d = kpt3d @ K.T
        kpt2d = kpt2d[:, :2] / kpt2d[:, 2:]
        obj_com = self.host.com[obj_id] @ obj_rt[:3, :3].T + obj_rt[:3, 3]

        gravity = self.get_gravity(sample_path)
        # train items derive is_grasped from the computed contact (ho3d3.py:
        # 155-166) — the is_off_desk asset is consulted only by eval items
        contact = self.get_contact(vert3d, obj_id, obj_rt)
        force_contact = anchor_lib.pool_contact_to_anchors_np(self.tables, contact)
        is_grasped = float(anchor_lib.check_is_grasped_np(force_contact))
        force_local = self.get_force(rgb_path)

        # the DexYCB crop and augmentation helpers
        helper = DexYCBForceDataset.__new__(DexYCBForceDataset)
        helper.cfg = self.cfg
        if self.is_train:
            center_jit = self.cfg.center_jittering * rng.uniform(-1, 1, 2)
            scale = self.cfg.scale_factor * rng.rand() + 1
            rot = (rng.uniform(-1, 1) * self.cfg.max_rot / 180 * np.pi
                   if rng.rand() < self.cfg.rot_prob else 0.0)
        else:
            center_jit, scale, rot = np.zeros(2), 1.0, 0.0

        for _ in range(100):
            R3, A2, K_crop = helper._augmentation_rotmat(center_jit, scale, rot, jt2d, kpt2d, K)
            _jt2d2 = jt2d @ A2[:2, :2].T + A2[:2, 2]
            _kpt2d2 = kpt2d @ A2[:2, :2].T + A2[:2, 2]
            bbox_hand = expand_bbox(pt2d_to_bbox(_jt2d2), 1.15)
            bbox_hand_rect = rectangularize(bbox_hand)
            bbox_obj = expand_bbox(pt2d_to_bbox(_kpt2d2), 1.10)
            bbox_obj_rect = rectangularize(bbox_obj)
            if bbox_in_image(bbox_hand_rect, P) and bbox_in_image(bbox_obj_rect, P):
                break
            scale *= 1.01
        jt2d_c, kpt2d_c = _jt2d2, _kpt2d2
        patch = None
        if not self.device_mode:
            patch = warp_host(rgb, A2, P)

        jt3d = jt3d @ R3.T
        global_rot = _mat_to_aa(R3 @ _aa_to_mat(global_rot))
        vert3d, _jt3d = get_hand_vert(aa_flat, beta, global_rot, transl, True)
        corr = jt3d[0] - _jt3d[0]
        transl = transl + corr
        vert3d = vert3d + corr
        obj_rt[:3, :3] = R3 @ obj_rt[:3, :3]
        obj_rt[:3, 3] = R3 @ obj_rt[:3, 3]
        gravity = gravity @ R3.T
        obj_com = obj_com @ R3.T

        aug_params = None
        if self.is_train:
            if self.device_mode:
                helper.augmentor = self.augmentor
                rgb = helper._clahe_source_region(rgb, rng, A2, P)
                aug_params = self.augmentor.sample_device_params(rng, P)
            else:
                patch = self.augmentor.run_color(patch, rng)

        root = jt3d[0].astype(np.float32)
        vert_rel = (vert3d - root).astype(np.float32)
        jt_rel = (jt3d - root).astype(np.float32)

        if self.device_mode:
            pixel_fields = {
                "rgb_full": rgb.astype(np.uint8),
                "warp_minv": np.linalg.inv(
                    np.vstack([A2[:2], [0.0, 0.0, 1.0]]))[:2].astype(np.float32),
                "jt2d": jt2d_c.astype(np.float32),
                "kpt2d": kpt2d_c.astype(np.float32),
            }
            if aug_params is not None:
                pixel_fields.update(aug_params)
        else:
            hm_hand = adaptive_bbox_heatmap_np(
                jt2d_c, bbox_hand, self.cfg.heatmap_size,
                self.cfg.heatmap_hand_sigma)
            hm_obj = square_bbox_heatmap_np(
                kpt2d_c, bbox_obj_rect, self.cfg.heatmap_size,
                self.cfg.heatmap_obj_sigma, True)

            rgb_norm = normalize_rgb(patch)
            if self.is_train:
                rgb_norm = self.augmentor.run_random_erasing(rgb_norm, rng)
            pixel_fields = {
                "rgb": rgb_norm.astype(np.float32),
                "hm_hand": hm_hand.astype(np.float32),
                "hm_obj": hm_obj.astype(np.float32),
            }

        rel_t = obj_rt[:3, 3] - root
        gt_obj = np.concatenate([_mat_to_rot6d(obj_rt[:3, :3]), rel_t]).astype(np.float32)

        return {
            "index": np.int32(index),
            "is_ho3d": True,
            **pixel_fields,
            "root_joint": root,
            "root_joint_flip": root,
            "bbox_hand": bbox_hand.astype(np.float32),
            "bbox_obj": bbox_obj.astype(np.float32),
            "bbox_hand_rect": bbox_hand_rect.astype(np.float32),
            "bbox_obj_rect": bbox_obj_rect.astype(np.float32),
            "is_right": True,
            "gt_obj": gt_obj,
            "gt_obj_rt": obj_rt[:3].astype(np.float32),
            "gt_mano": np.concatenate([global_rot, aa_flat, beta]).astype(np.float32),
            "gt_joint": jt3d.astype(np.float32),
            "gt_hand_vert": vert3d.astype(np.float32),
            "gt_hand_jt3d_flip": jt_rel,
            "gt_hand_vert_flip": vert_rel,
            "obj_id": np.int32(obj_id),
            "cam_intr": K,
            "cam_intr_crop": K_crop.astype(np.float32),
            "cam_intr_crop_flip": K_crop.astype(np.float32),
            "gravity": gravity.astype(np.float32),
            "obj_CoM": (obj_com - root)[None].astype(np.float32),
            "is_grasped": np.float32(is_grasped),
            "force_contact": force_contact.astype(np.float32),
            "force_local": force_local,
        }


    def get_eval_item(self, index: int) -> Dict[str, np.ndarray]:
        """Evaluation-split item (ho3d3.py:306-420): NO hand GT — the split
        publishes only the wrist joint + a hand bounding box; object pose IS
        annotated.  Crop framing uses the published hand bbox corners (not
        projected joints), expansion 1.2 hand / 1.00 object, no augmentation."""
        sample_path = self.index_ls[index]
        with open(sample_path + ".pkl", "rb") as f:
            sample = pickle.load(f)
        rgb_path = sample_path.replace("meta", "rgb") + ".png"
        rgb = imread_rgb(rgb_path)
        K = np.asarray(sample["camMat"], np.float32)
        P = self.cfg.patch_size

        root = (np.asarray(sample["handJoints3D"], np.float64).reshape(3)
                @ OPENGL_TO_OPENCV.T).astype(np.float32)
        bbox_hand = np.asarray(sample["handBoundingBox"], np.float32)

        obj_name = sample["objName"]
        obj_id = HO3D_OBJ_TO_YCB.get(obj_name, YCB_ID.get(obj_name, 1)) - 1
        obj_rot = OPENGL_TO_OPENCV @ _aa_to_mat(
            np.asarray(sample["objRot"], np.float64).reshape(3))
        obj_trans = OPENGL_TO_OPENCV @ np.asarray(
            sample["objTrans"], np.float64).reshape(3)
        obj_rt = np.concatenate([obj_rot, obj_trans[:, None]], axis=1).astype(np.float32)
        kpt3d = self.host.kpt3d[obj_id] @ obj_rt[:3, :3].T + obj_rt[:3, 3]
        kpt2d = kpt3d @ K.T
        kpt2d = kpt2d[:, :2] / kpt2d[:, 2:]

        helper = DexYCBForceDataset.__new__(DexYCBForceDataset)
        helper.cfg = self.cfg
        # bbox corners stand in for hand joints in the crop-framing loop
        # (bx2d2_to_bx2d4, ho3d3.py:338)
        x1, y1, x2, y2 = bbox_hand
        corners = np.array([[x1, y1], [x2, y1], [x1, y2], [x2, y2]], np.float32)
        center_jit, scale, rot = np.zeros(2), 1.0, 0.0  # eval: no aug
        for _ in range(100):
            R3, A2, K_crop = helper._augmentation_rotmat(
                center_jit, scale, rot, corners, kpt2d, K)
            patch = warp_host(rgb, A2, P)
            c2 = corners @ A2[:2, :2].T + A2[:2, 2]
            _kpt2d2 = kpt2d @ A2[:2, :2].T + A2[:2, 2]
            bb_hand = expand_bbox(pt2d_to_bbox(c2), 1.2)       # ho3d3.py:344
            bbox_hand_rect = rectangularize(bb_hand)
            bbox_obj = expand_bbox(pt2d_to_bbox(_kpt2d2), 1.0)  # :347
            bbox_obj_rect = rectangularize(bbox_obj)
            if bbox_in_image(bbox_hand_rect, P) and bbox_in_image(bbox_obj_rect, P):
                break
            scale *= 1.01
        kpt2d_c = _kpt2d2

        # R3 is identity at eval (no rotation aug) but applied for parity
        obj_rt[:3, :3] = R3 @ obj_rt[:3, :3]
        obj_rt[:3, 3] = R3 @ obj_rt[:3, 3]
        root = (R3 @ root.astype(np.float64)).astype(np.float32)

        hm_obj = square_bbox_heatmap_np(
            kpt2d_c, bbox_obj_rect, self.cfg.heatmap_size,
            self.cfg.heatmap_obj_sigma, True)
        rgb_norm = normalize_rgb(patch)

        rel_t = obj_rt[:3, 3] - root
        gt_obj = np.concatenate([_mat_to_rot6d(obj_rt[:3, :3]), rel_t]).astype(np.float32)

        return {
            "index": np.int32(index),
            "is_ho3d": True,
            "rgb": rgb_norm.astype(np.float32),
            "root_joint": root,
            "root_joint_flip": root,
            "bbox_hand": bb_hand.astype(np.float32),
            "bbox_obj": bbox_obj.astype(np.float32),
            "bbox_hand_rect": bbox_hand_rect.astype(np.float32),
            "bbox_obj_rect": bbox_obj_rect.astype(np.float32),
            "hm_obj": hm_obj.astype(np.float32),
            "is_right": True,
            "gt_obj": gt_obj,
            "gt_obj_rt": obj_rt[:3].astype(np.float32),
            "obj_id": np.int32(obj_id),
            "cam_intr": K,
            "cam_intr_crop": K_crop.astype(np.float32),
            "cam_intr_crop_flip": K_crop.astype(np.float32),
            "gravity": np.zeros((1, 3), np.float32),      # ho3d3.py:411
            "obj_CoM": np.zeros((1, 3), np.float32),
            "is_grasped": np.float32(self.get_is_grasped(sample_path)),
            "force_local": np.zeros((32, 3), np.float32),
        }


def dump_codalab(pred_joints, pred_verts, out_path: str) -> str:
    """One codalab submission zip (train_diff_hand_obj.py:872-880 `dump` +
    the zip/rm sequence at :430-435): ``[joints, verts]`` rounded to 6
    decimals in a json, zipped flat, json removed."""
    import zipfile

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    payload = [
        [np.around(np.asarray(j, np.float64), 6).tolist() for j in pred_joints],
        [np.around(np.asarray(v, np.float64), 6).tolist() for v in pred_verts],
    ]
    json_path = out_path if out_path.endswith(".json") else out_path + ".json"
    with open(json_path, "w") as f:
        json.dump(payload, f)
    zip_path = json_path[: -len(".json")] + ".zip"
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(json_path, os.path.basename(json_path))
    os.remove(json_path)
    return zip_path
