"""DexYCB loader (counterpart of ``vpho_tpu/data/dexycb.py``): the index and its filters,
the per-item geometry, the augmentation draws, ``collate`` and a threaded ``make_loader``.

Items equal the JAX package's: the same files, the same per-item
``np.random.RandomState((index * 9973 + 7) % 2**31)`` draws in the same order, the same
arithmetic.  MANO FK runs through the port's ``models/mano.py`` on the CPU, and the contact
labels' nearest-point search through ``native``'s numpy forms.  What an item carries:
  * spatial augmentation (train): centre jitter, scale and an in-plane rotation, applied to
    the image as a 2-D affine and to the 3-D labels as the matching optical-axis rotation,
    with the retry loop that keeps both boxes inside the crop;
  * the FK translation correction after that rotation;
  * the left-hand flip: image and hand flipped, the object never, the translation
    re-corrected through the wrist;
  * the object pose relative to the wrist.
Host mode (the default) crops with ``cv2.warpAffine`` and runs the colour augmentation,
erasing and heatmaps here; device mode (``--device_preprocess``) ships the decoded frame,
the crop's inverse affine (a left hand's flip folded in), the 2-D points and the drawn
augmentation parameters to ``data/device_pipeline.py``.  The index list is cached as
``cache/annotation/<mode>_<split>_index_tpu.json`` under the data directory, the JAX
package's file, which both packages read and write alike.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..configs.config import Config
from ..models import anchor as anchor_lib
from ..models.mano import MANOModel, load_mano, mano_fk
from ..models.ycb import load_registry
from ..native import contact_weight, min_dist
from ..ops.heatmap import adaptive_bbox_heatmap_np, square_bbox_heatmap_np
from ..parallel import mesh
from .augment import ImageAugmentor, normalize_rgb
from .codec import imread_rgb, require_cv2


# ---------------------------------------------------------------------------
# bbox helpers (misc_fn.py:88-247 numpy subset)
# ---------------------------------------------------------------------------


def pt2d_to_bbox(pts: np.ndarray) -> np.ndarray:
    return np.array([pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()])


def expand_bbox(bbox: np.ndarray, scale: float = 1.0) -> np.ndarray:
    c = (bbox[:2] + bbox[2:]) / 2
    half = (bbox[2:] - bbox[:2]) / 2 * scale
    return np.concatenate([c - half, c + half])


def rectangularize(bbox: np.ndarray) -> np.ndarray:
    c = (bbox[:2] + bbox[2:]) / 2
    half = (bbox[2:] - bbox[:2]).max() / 2
    return np.concatenate([c - half, c + half])


def bbox_in_image(bbox: np.ndarray, size: int) -> bool:
    return (bbox[0] >= 0 and bbox[1] >= 0 and bbox[2] <= size and bbox[3] <= size
            and bbox[0] < bbox[2] and bbox[1] < bbox[3])


# ---------------------------------------------------------------------------
# sample filters (base.py:284-346)
# ---------------------------------------------------------------------------


def filter_hfl(sample: dict) -> bool:
    """2023_CVPR_HFL: 1.5x-expanded hand bbox must fit in the 640x480 frame."""
    jt2d = np.array(sample["joint_2d"], np.float32).squeeze()
    x1, y1, x2, y2 = pt2d_to_bbox(jt2d)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w, h = (x2 - x1) * 1.5, (y2 - y1) * 1.5
    x, y = cx - w / 2, cy - h / 2
    x1c, y1c = max(0, x), max(0, y)
    x2c = min(640 - 1, x1c + max(0, w - 1))
    y2c = min(480 - 1, y1c + max(0, h - 1))
    return bool(w * h > 0 and x2c >= x1c and y2c >= y1c)


def filter_artiboost(sample: dict, registry, thresh_mm: float = 50.0) -> bool:
    """2022_CVPR_ArtiBoost: right hands, visible, hand-object distance <= 50mm."""
    if sample["mano_side"] == "left":
        return False
    jt2d = np.array(sample["joint_2d"], np.float32).squeeze()
    if np.all(jt2d == -1.0):
        return False
    jt3d = np.array(sample["joint_3d"], np.float32).squeeze()
    rt = np.array(sample["pose_y"][sample["ycb_grasp_ind"]], np.float32)
    obj_id = sample["ycb_ids"][sample["ycb_grasp_ind"]] - 1
    verts = registry.verts_sampled[obj_id].cpu().numpy()
    vt = verts @ rt[:3, :3].T + rt[:3, 3]
    d = np.linalg.norm(vt[:, None] - jt3d[None], axis=-1).min()
    return bool(d * 1000.0 <= thresh_mm)


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals of a triangle mesh (trimesh's convention)."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])  # area-weighted
    out = np.zeros_like(v)
    for i in range(3):
        np.add.at(out, f[:, i], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


def signed_contact_weights(hand_vert: np.ndarray, faces: np.ndarray,
                           obj_pts: np.ndarray, lo: float = -0.01,
                           hi: float = 0.01, decay_lo: float = -0.005,
                           decay_hi: float = 0.005,
                           tangential_thresh: float = 0.01) -> np.ndarray:
    """Signed banded contact weights (detect_hand_and_object_contact,
    physics_fn.py:47-112):
      nd = dot(hand_vert - nearest_obj_pt, hand_vertex_normal)   (signed!)
      mask: lo < nd < hi  AND  tangential offset < tangential_thresh
      weight: peak-normalized double-sigmoid band over nd.
    """
    hand_vert = np.asarray(hand_vert, np.float32)
    _, idx = min_dist(hand_vert, np.asarray(obj_pts, np.float32))
    normals = vertex_normals(hand_vert, faces)
    vec = hand_vert - np.asarray(obj_pts, np.float32)[idx]
    nd = np.sum(vec * normals, axis=-1)
    tangential = np.linalg.norm(vec - nd[:, None] * normals, axis=-1)
    w = contact_weight(nd, lo=lo, hi=hi, decay_lo=decay_lo, decay_hi=decay_hi)
    mask = (nd > lo) & (nd < hi) & (tangential < tangential_thresh)
    w[~mask] = 0.0
    return w.astype(np.float32)


def _aa_to_mat(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa)
    if theta < 1e-9:
        return np.eye(3)
    k = aa / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _mat_to_aa(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-9:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    axis = axis / (2 * np.sin(theta))
    return axis * theta


def _mat_to_rot6d(R: np.ndarray) -> np.ndarray:
    return R[:2, :].reshape(6)


@functools.lru_cache(maxsize=4)
def host_mano(side: str) -> MANOModel:
    """The MANO model of one side on the CPU, for the loaders' single-sample FK."""
    return load_mano(side=side, device="cpu")


def get_hand_vert(pose_aa_flat: np.ndarray, beta: np.ndarray, global_rot: np.ndarray,
                  transl: np.ndarray, is_right: bool):
    """FK with a global rotation and translation, in metres: (778, 3) verts, (21, 3) joints.
    The FK is wrist-centred, so the translation places the wrist."""
    model = host_mano("right" if is_right else "left")
    pose = torch.from_numpy(np.concatenate([global_rot, pose_aa_flat]).astype(np.float32))
    with torch.no_grad():
        verts, joints = mano_fk(model, pose[None], torch.from_numpy(
            np.asarray(beta, np.float32))[None])
    return verts[0].numpy() / 1000.0 + transl, joints[0].numpy() / 1000.0 + transl


def check_device_rotation(cfg: Config, is_train: bool) -> bool:
    """Whether items are device-mode; raises where the device warp cannot follow the
    rotation: its two passes divide by cos(rot) / scale, so rotations near 90 degrees would
    give blank or NaN crops."""
    device_mode = bool(cfg.device_preprocess)
    if device_mode and is_train and cfg.max_rot >= 85:
        raise ValueError(f"--device_preprocess supports --max_rot < 85 deg (got "
                         f"{cfg.max_rot}); use the host pipeline for larger rotations")
    return device_mode


@functools.lru_cache(maxsize=4)
def host_tables(models_dir: str | None) -> "HostTables":
    """The loaders' constants for ``models_dir``, built once per process (they are read-only)."""
    return HostTables(models_dir)


class HostTables:
    """The registry, MANO and anchor tables of the loaders, on the CPU and in numpy."""

    def __init__(self, models_dir: str | None):
        reg = load_registry(models_dir, device="cpu")
        self.registry = reg
        self.kpt3d, self.com = reg.kpt3d.numpy(), reg.com.numpy()
        self.verts_full, self.verts_full_mask = reg.verts_full.numpy(), reg.verts_full_mask.numpy()
        self.mano_r, self.mano_l = host_mano("right"), host_mano("left")
        self.tables = anchor_lib.load_anchor_tables(self.mano_r, device="cpu")


class DexYCBForceDataset:
    """The DexYCB dataset: ``__getitem__(i)`` is one item's dict of numpy arrays."""

    def __init__(self, cfg: Config, data_dir: str, is_train: bool):
        self.cfg = cfg
        self.data_dir = data_dir
        self.is_train = is_train
        self.host = host_tables(cfg.models_dir or os.path.join(data_dir, "models"))
        self.registry = self.host.registry
        self.mano_r, self.mano_l = self.host.mano_r, self.host.mano_l
        self.tables = self.host.tables
        self.augmentor = ImageAugmentor.from_config(cfg)
        self.samples, self.index_ls = self._load_samples()
        self.date2extr, self.date_ls = self._load_cam_extr()
        self.date2gravity = self._load_gravity()
        self.device_mode = check_device_rotation(cfg, is_train)
        self._warned: set = set()

    # -- index / caches --------------------------------------------------

    def _load_samples(self):
        split = "train" if self.is_train else "test"
        s0_json = os.path.join(self.data_dir, f"dex_ycb_s0_{split}_data.json")
        index_path = os.path.join(
            self.data_dir, "cache", "annotation",
            f"{self.cfg.clean_data_mode}_{split}_index_tpu.json")
        with open(s0_json, "r") as f:
            data = json.load(f)
        if os.path.exists(index_path):
            with open(index_path) as f:
                index_ls = json.load(f)
        else:
            index_ls = []
            for k, v in data.items():
                if not self._skip(v):
                    index_ls.append(k)
            os.makedirs(os.path.dirname(index_path), exist_ok=True)
            tmp = f"{index_path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(index_ls, f)
            os.replace(tmp, index_path)
        return data, index_ls

    def _skip(self, sample: dict) -> bool:
        mode = self.cfg.clean_data_mode
        if mode in ("2023_CVPR_HFL", "2023_WACV_DMA", "2023_NIPS_DeepSimHO"):
            if self.is_train:
                return not filter_hfl(sample)
            if mode == "2023_CVPR_HFL":
                return False
            # DMA / DeepSimHO test lists need their published asset files
            asset = {"2023_WACV_DMA": "asset/2023_WACV_DMA/test_idx/dex-ycb_test.pkl",
                     "2023_NIPS_DeepSimHO": "asset/2023_NIPS_DeepSimHO/cache/DexYCB/valid.txt"}[mode]
            if not os.path.exists(asset):
                raise FileNotFoundError(
                    f"{mode} test filtering requires {asset} (reference "
                    f"dexycb6.py:58-84)")
            if mode == "2023_WACV_DMA":
                with open(asset, "rb") as f:
                    frames = pickle.load(f)["frame_index"]["img"].tolist()
                self._dma = {x[10:] for x in frames}
                return sample["color_file"] not in self._dma
            with open(asset) as f:
                valid = {l.strip() for l in f}
            return sample["color_file"] not in valid
        if mode == "2022_CVPR_ArtiBoost":
            return not filter_artiboost(sample, self.registry)
        if mode == "stable_grasping":
            asset = "asset/ours/DexYCB/is_off_desk_5cm.pkl"
            if not os.path.exists(asset):
                raise FileNotFoundError(f"stable_grasping requires {asset}")
            if not hasattr(self, "_off_desk"):
                with open(asset, "rb") as f:
                    self._off_desk = pickle.load(f)
            d = sample["color_file"].split("/")
            seq = d[0] + "/" + d[1]
            return not self._off_desk[seq][int(d[-1].split(".")[0].split("_")[-1])]
        raise NotImplementedError(mode)

    def _load_cam_extr(self):
        path = os.path.join(self.data_dir, "calibration")
        date2extr, dates = {}, []
        if os.path.isdir(path):
            import yaml

            for f in sorted(os.listdir(path)):
                if "extrinsic" in f:
                    with open(os.path.join(path, f, "extrinsics.yml")) as file:
                        extr = yaml.safe_load(file)["extrinsics"]
                    date = int(f.split("_")[1])
                    date2extr[date] = {k: np.array(v).reshape(3, 4) for k, v in extr.items()}
                    dates.append(date)
        return date2extr, np.array(dates)

    def _load_gravity(self, path="asset/ours/DexYCB/gravity_direction.json"):
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {k: np.array(v)[None] for k, v in json.load(f).items()}

    def _warn_once(self, key, msg):
        if key not in self._warned:
            warnings.warn(msg)
            self._warned.add(key)

    def get_gravity(self, color_file: str) -> np.ndarray:
        d = color_file.split("/")
        key = d[0] + "/" + d[1] + "/" + "840412060917"
        if key in self.date2gravity and len(self.date_ls):
            g = self.date2gravity[key]
            date = int(d[-3].split("_")[0]) if d[-3][0].isdigit() else int(d[0].split("-")[0])
            mask = (self.date_ls - date) <= 0
            nearest = self.date_ls[mask].max() if mask.any() else self.date_ls.min()
            extr = self.date2extr[nearest][d[-2]]
            return (g @ extr[:3, :3]).reshape(1, 3)
        self._warn_once("gravity", "gravity assets missing; using camera-down unit [0, 1, 0]")
        return np.array([[0.0, 1.0, 0.0]])

    def get_force(self, color_file: str):
        p = os.path.join(self.data_dir, "cache", "hand_force",
                         color_file.replace(".jpg", ".pkl").replace("color_", "hand_force_"))
        if os.path.exists(p):
            with open(p, "rb") as f:
                dt = pickle.load(f)
            return np.asarray(dt["force_local"], np.float32)
        self._warn_once("force", "pseudo-force cache missing (run force_optim); using zeros")
        return np.zeros((32, 3), np.float32)

    def get_contact(self, color_file: str, hand_vert_fn, obj_id: int,
                    obj_rt: np.ndarray, is_right: bool = True) -> np.ndarray:
        """Per-hand-vertex contact weight: SIGNED normal distance to the
        nearest object point pushed through the sigmoid band
        (detect_hand_and_object_contact, physics_fn.py:47-112):
          nd = dot(hand_vert - nearest_obj_vert, hand_vertex_normal)
          mask: lo < nd < hi AND tangential offset < 1 cm
          weight: 1/((1+e^{-1600(nd-mid1)})(1+e^{1600(nd-mid2)})), peak-normalized.
        The reference's LIVE path is get_hand_contact (base.py:841-911, called
        at dexycb6.py:320) — NN against the FULL object mesh verts, normal +
        vertical distance thresholds from cfg, no depth rendering (the
        front/back render cache feeds only get_hand_and_object_contact, whose
        per-pixel maps the live dataset never consumes).

        Memoized per image to ``cache/hand_contact/<seq>/contact_*.npy``
        exactly like the reference (base.py:871-881: color_ -> contact_,
        .jpg -> .npy) — the labels depend only on the UNAUGMENTED annotation,
        so the full-mesh NN runs once per image ever, not once per epoch.
        Cache write failures (read-only tree) degrade to recompute + one
        warning."""
        lo, hi = getattr(self.cfg, "contact_normal_distance_thresh", (-0.01, 0.01))
        vthresh = getattr(self.cfg, "contact_vertical_distance_thresh", 0.005)
        # the labels depend on the threshold config too: non-default
        # thresholds get their own cache namespace so a threshold change
        # can never silently serve stale labels (the reference's own cache
        # has this staleness bug — its key is the image path alone)
        ns = ("hand_contact" if (lo, hi, vthresh) == (-0.01, 0.01, 0.005)
              else f"hand_contact_{lo:g}_{hi:g}_{vthresh:g}")
        cache_path = os.path.join(
            self.data_dir, "cache", ns,
            color_file.replace("color_", "contact_").replace(".jpg", ".npy"))
        if os.path.exists(cache_path):
            return np.load(cache_path).astype(np.float32)
        verts = self.host.verts_full[obj_id]
        obj_cam = verts @ obj_rt[:3, :3].T + obj_rt[:3, 3]
        faces = (self.mano_r if is_right else self.mano_l).faces
        w = signed_contact_weights(hand_vert_fn(), faces, obj_cam, lo=lo,
                                   hi=hi, tangential_thresh=vthresh)
        try:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            tmp = cache_path + f".tmp{os.getpid()}_{threading.get_ident()}"
            with open(tmp, "wb") as f:  # atomic rename: loader threads race
                np.save(f, w)
            os.replace(tmp, cache_path)
        except OSError as e:
            self._warn_once("contact_cache",
                            f"hand_contact cache not writable ({e}); "
                            f"recomputing per epoch")
        return w

    def __len__(self):
        return len(self.index_ls)

    # -- per-item pipeline ------------------------------------------------

    def get_path(self, index: int) -> str:
        """The frame's path relative to the data directory (the prediction pkl's 'path')."""
        return self.samples[self.index_ls[index]]["color_file"]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.samples[self.index_ls[index]]
        rng = np.random.RandomState((index * 9973 + 7) % 2**31)
        P = self.cfg.patch_size

        rgb_path = os.path.join(self.data_dir, sample["color_file"])
        rgb = imread_rgb(rgb_path)
        K = np.array([[sample["intrinsics"]["fx"], 0, sample["intrinsics"]["ppx"]],
                      [0, sample["intrinsics"]["fy"], sample["intrinsics"]["ppy"]],
                      [0, 0, 1]], np.float32)

        is_right = sample["mano_side"] == "right"
        pose_m = np.array(sample["pose_m"], np.float32).squeeze()
        beta = np.array(sample["mano_betas"], np.float32)
        jt3d = np.array(sample["joint_3d"], np.float32).squeeze()
        jt2d = np.array(sample["joint_2d"], np.float32).squeeze()
        global_rot = pose_m[:3].copy()
        transl = pose_m[-3:].copy()
        pca = pose_m[3:-3]
        mano_model = self.mano_r if is_right else self.mano_l
        aa_mean = pca @ mano_model.hands_components
        aa_flat = aa_mean + mano_model.hands_mean

        obj_rt = np.array(sample["pose_y"][sample["ycb_grasp_ind"]], np.float32)
        obj_id = sample["ycb_ids"][sample["ycb_grasp_ind"]] - 1
        kpt3d = self.host.kpt3d[obj_id] @ obj_rt[:3, :3].T + obj_rt[:3, 3]
        kpt2d = kpt3d @ K.T
        kpt2d = kpt2d[:, :2] / kpt2d[:, 2:]
        obj_com = self.host.com[obj_id] @ obj_rt[:3, :3].T + obj_rt[:3, 3]

        gravity = self.get_gravity(sample["color_file"]).astype(np.float32)

        # contact -> anchors -> is_grasped (host-side numpy)
        # lazy: the pre-aug FK is only needed on a contact-cache MISS
        contact = self.get_contact(
            sample["color_file"],
            lambda: get_hand_vert(aa_flat, beta, global_rot, transl,
                                  is_right)[0],
            obj_id, obj_rt, is_right)
        force_contact = anchor_lib.pool_contact_to_anchors_np(self.tables, contact)
        is_grasped = anchor_lib.check_is_grasped_np(force_contact)
        force_local = self.get_force(sample["color_file"])

        # spatial augmentation with bbox-in-frame retry (dexycb6.py:339-364)
        if self.is_train:
            center_jit = self.cfg.center_jittering * rng.uniform(-1, 1, 2)
            scale = self.cfg.scale_factor * rng.rand() + 1
            rot = (rng.uniform(-1, 1) * self.cfg.max_rot / 180 * np.pi
                   if rng.rand() < self.cfg.rot_prob else 0.0)
        else:
            center_jit, scale, rot = np.zeros(2), 1.0, 0.0

        for _ in range(100):
            R3, A2, K_crop = self._augmentation_rotmat(center_jit, scale, rot, jt2d, kpt2d, K)
            _jt2d = jt2d @ A2[:2, :2].T + A2[:2, 2]
            _kpt2d = kpt2d @ A2[:2, :2].T + A2[:2, 2]
            bbox_hand = expand_bbox(pt2d_to_bbox(_jt2d), 1.15)
            bbox_hand_rect = rectangularize(bbox_hand)
            bbox_obj = expand_bbox(pt2d_to_bbox(_kpt2d), 1.10)
            bbox_obj_rect = rectangularize(bbox_obj)
            if bbox_in_image(bbox_hand_rect, P) and bbox_in_image(bbox_obj_rect, P):
                break
            scale *= 1.01
        else:
            raise ValueError(f"index {index}: bbox out of image")
        jt2d, kpt2d = _jt2d, _kpt2d
        patch = None
        if not self.device_mode:
            # only the accepted affine is ever rendered (the retry loop is
            # pure 2D-point math, no pixel work)
            patch = warp_host(rgb, A2, P)

        # 3D rotation consistency + FK translation fix (dexycb6.py:368-387)
        jt3d = jt3d @ R3.T
        global_rot = _mat_to_aa(R3 @ _aa_to_mat(global_rot))
        gt_hand_vert, _jt3d = get_hand_vert(aa_flat, beta, global_rot, transl, is_right)
        corr = jt3d[0] - _jt3d[0]
        transl = transl + corr
        gt_hand_vert = gt_hand_vert + corr
        obj_rt = obj_rt.copy()
        obj_rt[:3, :3] = R3 @ obj_rt[:3, :3]
        obj_rt[:3, 3] = R3 @ obj_rt[:3, 3]
        gravity = gravity @ R3.T
        obj_com = obj_com @ R3.T

        aug_params = None
        if self.is_train:
            if self.device_mode:
                rgb = self._clahe_source_region(rgb, rng, A2, P)
                aug_params = self.augmentor.sample_device_params(
                    rng, P, mirror=not is_right)
            else:
                patch = self.augmentor.run_color(patch, rng)

        # left-hand flip protocol (dexycb6.py:394-431)
        gt_hand_vert_flip = gt_hand_vert.copy()
        gt_jt3d_flip = jt3d.copy()
        K_crop_flip = K_crop.copy()
        if not is_right:
            if patch is not None:
                patch = patch[:, ::-1].copy()
            jt2d = jt2d.copy()
            jt2d[:, 0] = P - jt2d[:, 0]
            gt_jt3d_flip[:, 0] *= -1
            gt_hand_vert_flip[:, 0] *= -1
            kpt2d = kpt2d.copy()
            kpt2d[:, 0] = P - kpt2d[:, 0]
            for b in (bbox_hand, bbox_obj, bbox_hand_rect, bbox_obj_rect):
                b[[0, 2]] = P - b[[2, 0]]
            aa = aa_mean.reshape(-1, 3).copy()
            aa[:, 1:] *= -1
            aa_mean = aa.reshape(-1)
            global_rot = global_rot.copy()
            global_rot[1:] *= -1
            transl = transl.copy()
            transl[0] *= -1
            K_crop_flip[0, 2] = P - K_crop_flip[0, 2]
            aa_flat = aa_mean + self.mano_r.hands_mean
            # reference: FK the flipped hand and re-correct the translation
            # through its wrist (dexycb6.py:425-431).  Our FK is
            # wrist-centered (joints[0] == 0, so FK root == transl), which
            # collapses that correction to transl = flipped root — no FK
            # dispatch needed (pinned by test_left_hand_flip_protocol)
            transl = gt_jt3d_flip[0].copy()
        # final root through the (possibly flipped) FK: wrist-centered FK
        # makes it exactly transl (== gt_jt3d_flip root by construction)
        root_flip = gt_jt3d_flip[0].astype(np.float32)
        gt_hand_vert_flip = gt_hand_vert_flip - gt_jt3d_flip[0]
        gt_jt3d_flip = gt_jt3d_flip - gt_jt3d_flip[0]

        if self.device_mode:
            # pixel work deferred to the device graph: ship the decoded
            # frame, the dst->src affine (flip folded in for left hands),
            # post-warp 2D points + aug knobs; data/device_pipeline.py
            # produces rgb / hm_hand / hm_obj on-device
            A3 = A2.copy()
            if not is_right:
                A3 = np.array([[-1.0, 0.0, P - 1.0],
                               [0.0, 1.0, 0.0],
                               [0.0, 0.0, 1.0]]) @ A3
            minv = np.linalg.inv(A3)[:2].astype(np.float32)
            pixel_fields = {
                "rgb_full": rgb.astype(np.uint8),
                "warp_minv": minv,
                "jt2d": jt2d.astype(np.float32),
                "kpt2d": kpt2d.astype(np.float32),
            }
            if aug_params is not None:
                pixel_fields.update(aug_params)
        else:
            # heatmaps (dexycb6.py:433-438): hand adaptive, obj square —
            # native host kernels (no per-sample device dispatch in workers)
            hm_hand = adaptive_bbox_heatmap_np(
                jt2d, bbox_hand, self.cfg.heatmap_size,
                self.cfg.heatmap_hand_sigma)
            hm_obj = square_bbox_heatmap_np(
                kpt2d, bbox_obj_rect, self.cfg.heatmap_size,
                self.cfg.heatmap_obj_sigma, is_right)

            rgb_norm = normalize_rgb(patch)
            if self.is_train:
                rgb_norm = self.augmentor.run_random_erasing(rgb_norm, rng)
            pixel_fields = {
                "rgb": rgb_norm.astype(np.float32),          # HWC (NHWC batch)
                "hm_hand": hm_hand.astype(np.float32),
                "hm_obj": hm_obj.astype(np.float32),
            }

        # wrist-relative object pose; object never flipped (dexycb6.py:446-451)
        root = jt3d[0].astype(np.float32)
        rel_t = obj_rt[:3, 3] - root
        gt_obj = np.concatenate([_mat_to_rot6d(obj_rt[:3, :3]), rel_t]).astype(np.float32)
        mano_params = np.concatenate([global_rot, aa_flat, beta]).astype(np.float32)

        return {
            "index": np.int32(index),
            "is_ho3d": False,
            **pixel_fields,
            "root_joint": root,
            "bbox_hand": bbox_hand.astype(np.float32),
            "bbox_obj": bbox_obj.astype(np.float32),
            "bbox_hand_rect": bbox_hand_rect.astype(np.float32),
            "bbox_obj_rect": bbox_obj_rect.astype(np.float32),
            "is_right": bool(is_right),
            "gt_obj": gt_obj,
            "gt_obj_rt": obj_rt[:3].astype(np.float32),      # camera frame
            "gt_mano": mano_params,
            "gt_joint": jt3d.astype(np.float32),
            "gt_hand_vert": gt_hand_vert.astype(np.float32),
            "gt_hand_jt3d_flip": gt_jt3d_flip.astype(np.float32),
            "gt_hand_vert_flip": gt_hand_vert_flip.astype(np.float32),
            "root_joint_flip": root_flip,
            "obj_id": np.int32(obj_id),
            "cam_intr": K,
            "cam_intr_crop": K_crop.astype(np.float32),
            "cam_intr_crop_flip": K_crop_flip.astype(np.float32),
            "gravity": gravity.astype(np.float32),           # (1, 3)
            "obj_CoM": (obj_com - root)[None].astype(np.float32),
            "is_grasped": np.float32(is_grasped),
            "force_contact": force_contact.astype(np.float32),
            "force_local": force_local,
        }

    def _clahe_source_region(self, rgb, rng, A2, P):
        """Device-mode CLAHE: equalize only the source pixels the warp reads.

        The host path runs CLAHE on the warped patch (reference order);
        with the warp on-device, equalizing the axis-aligned source bbox of
        the crop (+2px bicubic margin) is the closest host-side stand-in —
        same content, same 8x8 tile scale relative to the hand, ~4x cheaper
        than the full 640x480 frame (DEVIATIONS.md D15).  Draw order
        matches run_color (clahe gate first) to keep the host/device RNG
        streams aligned.
        """
        if rng.rand() >= self.augmentor.cfg.clahe_prob:
            return rgb
        corners = np.array([[0, 0], [P - 1, 0], [0, P - 1], [P - 1, P - 1]],
                           np.float32)
        inv = np.linalg.inv(A2)
        src = corners @ inv[:2, :2].T + inv[:2, 2]
        x0, y0 = np.floor(src.min(0)).astype(int) - 2
        x1, y1 = np.ceil(src.max(0)).astype(int) + 3
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(rgb.shape[1], x1), min(rgb.shape[0], y1)
        if x1 - x0 < 8 or y1 - y0 < 8:
            return rgb
        out = rgb.copy()
        out[y0:y1, x0:x1] = self.augmentor._clahe(rgb[y0:y1, x0:x1], rng)
        return out

    def _augmentation_rotmat(self, center_jit, scale_factor, rot, jt2d, kpt2d, K):
        """base.py:522-574: joint 2D affine + matching 3D optical-axis rot."""
        P = self.cfg.patch_size
        bh = rectangularize(expand_bbox(pt2d_to_bbox(jt2d)))
        bo = rectangularize(expand_bbox(pt2d_to_bbox(kpt2d)))
        center = np.concatenate([bh, bo]).reshape(-1, 2).mean(0)

        R3 = np.array([[np.cos(rot), -np.sin(rot), 0],
                       [np.sin(rot), np.cos(rot), 0],
                       [0, 0, 1]])
        all_pts = np.concatenate([jt2d, kpt2d], axis=0)
        radius = np.linalg.norm(all_pts - center, axis=-1).max()
        center = center + center_jit * radius
        radius = radius * self.cfg.bbox_scale_factor * scale_factor
        scale = P / (radius * 2)
        center_rot = center @ R3[:2, :2].T * scale
        t = np.array([P // 2, P // 2]) + 0.5 - center_rot
        A2 = np.array([[scale, 0, t[0]], [0, scale, t[1]], [0, 0, 1]]) @ R3

        crot = (center - K[:2, 2]) @ R3[:2, :2].T * scale
        t2 = np.array([P // 2, P // 2]) + 0.5 - crot
        K_crop = K.copy()
        K_crop[:2] *= scale
        K_crop[:2, 2] = t2
        return R3, A2, K_crop


def warp_host(rgb: np.ndarray, A2: np.ndarray, P: int) -> np.ndarray:
    """Host mode's crop: ``cv2.warpAffine`` bicubic with the forward affine A2 (3, 3)."""
    cv2 = require_cv2()
    return cv2.warpAffine(rgb, A2[:2], (P, P), flags=cv2.INTER_CUBIC)


LOADER_DEPTH = 4       # batches in flight in ``make_loader``, one thread each


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack([np.asarray(v) for v in vals], axis=0)
    return out


def make_loader(dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                subsample: int = 1, drop_last: bool = True) -> Iterator[Dict]:
    """Collated batches from a pool of ``LOADER_DEPTH`` threads: each batch is built by one
    thread, up to ``LOADER_DEPTH`` batches ahead of the consumer (cv2 and numpy release the
    GIL in decode and warp).  Items are seeded by their index, so the pool does not change
    what a batch holds.

    ``drop_last=False`` (eval) keeps the tail batch, padded to ``batch_size`` by repeating
    its last item; every batch then carries a ``_valid`` mask and the ``_index`` of its
    dataset items, so each item is scored once.

    On a data-parallel rank (``parallel/mesh.py``) a batch is the rank's rows of the global
    batch of ``batch_size`` and only their items are built.  An eval batch is padded up to a
    multiple of the world first; a train batch size must divide by it.
    """
    idx = np.arange(0, len(dataset), subsample)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    n = len(idx) // batch_size if drop_last else -(-len(idx) // batch_size)
    lo, hi, size = mesh.local_rows(batch_size)
    if drop_last and size != batch_size:
        raise ValueError(f"train batch size {batch_size} must be divisible by the "
                         f"{mesh.world_size()} ranks (set --batch_size or --num_devices)")
    rows = np.arange(lo, hi)

    def build(bi):
        sel = idx[bi * batch_size:(bi + 1) * batch_size]
        take = sel[np.minimum(rows, len(sel) - 1)]
        built: Dict[int, Dict[str, np.ndarray]] = {}
        for i in dict.fromkeys(int(i) for i in take):
            built[i] = dataset[i]
        batch = collate([built[int(i)] for i in take])
        if not drop_last:
            batch["_index"] = np.asarray(take, np.int64)
            batch["_valid"] = rows < len(sel)
        if mesh.is_distributed():
            batch["_n"] = np.full(len(rows), batch_size)     # the global batch's draws' size
        return batch

    with ThreadPoolExecutor(max_workers=LOADER_DEPTH) as ex:
        futures = [ex.submit(build, bi) for bi in range(min(n, LOADER_DEPTH))]
        next_bi = len(futures)
        for _ in range(n):
            batch = futures.pop(0).result()
            if next_bi < n:
                futures.append(ex.submit(build, next_bi))
                next_bi += 1
            yield batch
