"""YCB object registry as stacked tensors indexed by 0-based object id (counterpart of
``vpho_tpu/models/ycb.py``).

Real data path: a DexYCB ``models/`` directory (``textured_simple.obj`` per class, numpy
farthest-point sampling) or the JAX package's cached pkl; hermetic path: the same
deterministic synthetic registry as the JAX package, built from the same numpy draws.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..utils.platform import resolve_device

YCB_CLASSES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill", 16: "036_wood_block",
    17: "037_scissors", 18: "040_large_marker", 19: "051_large_clamp",
    20: "052_extra_large_clamp", 21: "061_foam_brick",
}
NUM_VERTS_SAMPLED = 2048

# BOP-style symmetric classes used by the object metrics
SYMMETRIC_CLASSES = ("024_bowl", "036_wood_block", "051_large_clamp",
                     "052_extra_large_clamp", "061_foam_brick")


class YCBRegistry(NamedTuple):
    """Per-object constants; axis 0 is (object_id - 1)."""

    kpt3d: torch.Tensor            # (21, 27, 3) bbox lattice keypoints
    verts_sampled: torch.Tensor    # (21, 2048, 3) FPS-sampled surface points
    verts_full: torch.Tensor       # (21, Vmax, 3) all vertices, padded with the first
    verts_full_mask: torch.Tensor  # (21, Vmax) 1 where a real vertex
    com: torch.Tensor              # (21, 3) centre of mass
    diameter: torch.Tensor         # (21,) bounding-box diagonal
    shift: torch.Tensor            # (21, 3, 4) to-axial-symmetry frames
    is_symmetric: torch.Tensor     # (21,) bool
    names: tuple


def bbox3d_from_verts(verts: np.ndarray) -> np.ndarray:
    return np.stack([verts.min(-2), verts.max(-2)], axis=-2)


def kpt27_from_bbox3d(bbox3d: np.ndarray) -> np.ndarray:
    """3x3x3 lattice over the box; index 13 is the centre."""
    mn, mx = bbox3d[..., 0, :], bbox3d[..., 1, :]
    kpts = []
    for i in range(3):
        for j in range(3):
            for k in range(3):
                w = np.array([i, j, k]) / 2.0
                kpts.append(mn + w * (mx - mn))
    return np.stack(kpts, axis=-2)


def get_diameter(verts: np.ndarray) -> float:
    """Bounding-box diagonal."""
    ext = verts.max(0) - verts.min(0)
    return float(np.sqrt((ext ** 2).sum()))


def farthest_point_sampling(verts: np.ndarray, n: int, start_idx: int = 0) -> np.ndarray:
    """Plain numpy FPS, O(n * V)."""
    V = verts.shape[0]
    if V <= n:
        return np.arange(V)
    chosen = np.empty(n, dtype=np.int64)
    chosen[0] = start_idx
    d2 = ((verts - verts[start_idx]) ** 2).sum(-1)
    for i in range(1, n):
        idx = int(d2.argmax())
        chosen[i] = idx
        d2 = np.minimum(d2, ((verts - verts[idx]) ** 2).sum(-1))
    return chosen


def load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
    return np.asarray(verts, np.float32)


def _registry_from_dicts(per_obj: list, names: list, device) -> YCBRegistry:
    vmax = max(d["verts"].shape[0] for d in per_obj)
    verts_full = np.zeros((len(per_obj), vmax, 3), np.float32)
    mask = np.zeros((len(per_obj), vmax), np.float32)
    for i, d in enumerate(per_obj):
        v = d["verts"]
        verts_full[i, :v.shape[0]] = v
        verts_full[i, v.shape[0]:] = v[0]          # padding repeats a real vertex
        mask[i, :v.shape[0]] = 1.0

    def stack(key):
        return torch.as_tensor(np.stack([np.asarray(d[key], np.float32) for d in per_obj]),
                               device=device)

    return YCBRegistry(kpt3d=stack("kpt3d"), verts_sampled=stack("verts_sampled"),
                       verts_full=torch.as_tensor(verts_full, device=device),
                       verts_full_mask=torch.as_tensor(mask, device=device),
                       com=stack("CoM"), diameter=stack("diameter"), shift=stack("shift"),
                       is_symmetric=torch.as_tensor([n in SYMMETRIC_CLASSES for n in names],
                                                    device=device),
                       names=tuple(names))


def build_registry_from_models_dir(model_dir: str, device=None) -> YCBRegistry:
    """Build from real DexYCB meshes (``textured_simple.obj`` per class dir)."""
    device = resolve_device(device)
    names = [YCB_CLASSES[i] for i in sorted(YCB_CLASSES)]
    def read_json(name):
        path = os.path.join(os.path.dirname(model_dir), name)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    shifts = read_json("object_shift_to_axial_symmetry.json")
    coms = read_json("object_center_of_mass.json")
    per_obj = []
    for name in names:
        verts = load_obj_vertices(os.path.join(model_dir, name, "textured_simple.obj"))
        shift = np.asarray(shifts.get(name, np.eye(3, 4)), np.float32)
        com = np.asarray(coms.get(name, verts.mean(0)), np.float32)
        verts_sampled = verts[farthest_point_sampling(verts, NUM_VERTS_SAMPLED)]
        vs_axsym = verts_sampled @ shift[:3, :3].T + shift[:3, 3]
        kpt_axsym = kpt27_from_bbox3d(bbox3d_from_verts(vs_axsym))
        kpt3d = (kpt_axsym - shift[:3, 3]) @ shift[:3, :3]
        per_obj.append(dict(verts=verts, verts_sampled=verts_sampled, kpt3d=kpt3d, CoM=com,
                            diameter=get_diameter(verts), shift=shift))
    return _registry_from_dicts(per_obj, names, device)


def synthetic_registry(seed: int = 0, verts_per_obj: int = 4000, device=None) -> YCBRegistry:
    """Deterministic synthetic registry with DexYCB-like object scales."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    names = [YCB_CLASSES[i] for i in sorted(YCB_CLASSES)]
    per_obj = []
    for _ in names:
        scale = 0.04 + 0.08 * rng.rand(3)
        verts = (rng.randn(verts_per_obj, 3) * scale).astype(np.float32)
        verts = verts / np.maximum(np.linalg.norm(verts / scale, axis=-1, keepdims=True), 1.0)
        vs = verts[farthest_point_sampling(verts, NUM_VERTS_SAMPLED)]
        kpt3d = kpt27_from_bbox3d(bbox3d_from_verts(vs)).astype(np.float32)
        per_obj.append(dict(verts=verts, verts_sampled=vs, kpt3d=kpt3d, CoM=verts.mean(0),
                            diameter=get_diameter(verts), shift=np.eye(3, 4, dtype=np.float32)))
    return _registry_from_dicts(per_obj, names, device)


_CACHE_DEFAULT = "asset/ours/object_mesh_info_tpu.pkl"


def load_registry(model_dir: str | None = None, device=None) -> YCBRegistry:
    """Real registry when meshes are on disk, synthetic otherwise."""
    device = resolve_device(device)
    if model_dir and os.path.isdir(model_dir):
        return build_registry_from_models_dir(model_dir, device)
    if os.path.exists(_CACHE_DEFAULT):
        with open(_CACHE_DEFAULT, "rb") as f:
            per_obj, names = pickle.load(f)
        return _registry_from_dicts(per_obj, names, device)
    return synthetic_registry(device=device)
