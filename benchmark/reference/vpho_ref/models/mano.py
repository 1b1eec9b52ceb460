"""MANO hand layer, LBS forward kinematics on torch tensors (counterpart of
``vpho_tpu/models/mano.py``).

Semantics are manopth's as the reference uses them: right hand, ``flat_hand_mean=True``, no
PCA, wrist-centred output.  ``mano_fk`` returns vertices (B, 778, 3) and joints (B, 21, 3) in
millimetres, joints in manopth order; ``hand_verts_meters`` / ``hand_joints_meters`` divide by
1000 and accept any leading batch dims.

Assets: ``MANO_RIGHT.pkl``/``MANO_LEFT.pkl`` when present, else the same deterministic
synthetic model as the JAX package, built from the same numpy draws.
"""
from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import torch

from ..utils.platform import device_index, resolve_device

TIP_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_SHAPE = 10


class MANOModel(NamedTuple):
    v_template: torch.Tensor      # (778, 3)
    shapedirs: torch.Tensor       # (778, 3, 10)
    posedirs: torch.Tensor        # (778, 3, 135)
    J_regressor: torch.Tensor     # (16, 778)
    weights: torch.Tensor         # (778, 16)
    side: str = "right"
    # host-side (numpy) tables of the data pipeline: mesh topology and the PCA pose basis
    faces: np.ndarray | None = None             # (1538, 3) int32
    hands_components: np.ndarray | None = None  # (45, 45) float32
    hands_mean: np.ndarray | None = None        # (45,) float32


def _from_numpy(arrays: dict, side: str, device, faces, hands_components,
                hands_mean) -> MANOModel:
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in arrays.items()}
    return MANOModel(side=side, faces=np.asarray(faces, np.int32),
                     hands_components=np.asarray(hands_components, np.float32),
                     hands_mean=np.asarray(hands_mean, np.float32), **t)


def _undo_chumpy(x):
    return np.asarray(x.r if hasattr(x, "r") else x, dtype=np.float64)


def load_mano_pkl(path: str, device=None) -> MANOModel:
    """Load an official MANO pkl (chumpy arrays inside) into tensors on ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    j_reg = data["J_regressor"]
    if hasattr(j_reg, "todense"):
        j_reg = np.asarray(j_reg.todense())
    side = "left" if "LEFT" in os.path.basename(path).upper() else "right"
    return _from_numpy(dict(
        v_template=_undo_chumpy(data["v_template"]),
        shapedirs=_undo_chumpy(data["shapedirs"]),
        posedirs=_undo_chumpy(data["posedirs"]),
        J_regressor=j_reg,
        weights=_undo_chumpy(data["weights"]),
    ), side, device, data["f"], _undo_chumpy(data["hands_components"]),
        _undo_chumpy(data["hands_mean"]))


def synthetic_mano(seed: int = 0, side: str = "right", device=None) -> MANOModel:
    """Deterministic synthetic MANO-shaped model (same draws as the JAX package)."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    joints = np.zeros((NUM_JOINTS, 3))
    finger_dirs = {
        1: np.array([0.95, 0.20, 0.0]),
        4: np.array([1.0, 0.0, 0.0]),
        7: np.array([0.90, -0.35, 0.0]),
        10: np.array([0.95, -0.18, 0.0]),
        13: np.array([0.60, 0.65, 0.0]),
    }
    for base, d in finger_dirs.items():
        d = d / np.linalg.norm(d)
        joints[base] = d * 0.09
        joints[base + 1] = d * 0.12
        joints[base + 2] = d * 0.145
    seg = rng.randint(0, NUM_JOINTS, size=NUM_VERTS)
    alpha = rng.rand(NUM_VERTS, 1)
    parents = np.array(PARENTS)
    parent_pos = joints[np.where(parents[seg] < 0, 0, parents[seg])]
    v_template = (parent_pos + alpha * (joints[seg] - parent_pos)
                  + rng.randn(NUM_VERTS, 3) * 0.008)
    j_reg = np.zeros((NUM_JOINTS, NUM_VERTS))
    d2 = ((joints[:, None] - v_template[None]) ** 2).sum(-1)
    nearest = np.argsort(d2, axis=1)[:, :20]
    for j in range(NUM_JOINTS):
        j_reg[j, nearest[j]] = 1.0 / 20
    w = np.exp(-d2.T / 0.002)
    weights = w / w.sum(1, keepdims=True)
    shapedirs = rng.randn(NUM_VERTS, 3, NUM_SHAPE) * 0.002
    posedirs = rng.randn(NUM_VERTS, 3, 135) * 0.0005
    faces = rng.randint(0, NUM_VERTS, size=(1538, 3))
    comps = np.linalg.qr(rng.randn(45, 45))[0]
    return _from_numpy(dict(v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
                            J_regressor=j_reg, weights=weights), side, device, faces, comps,
                       np.zeros(45))


_DEFAULT_SEARCH = (
    "asset/mano_v1_2/models",
    os.path.join(os.path.dirname(__file__), "..", "..", "asset", "mano_v1_2", "models"),
)


def load_mano(mano_root: str | None = None, side: str = "right", device=None) -> MANOModel:
    """The official MANO model if available, else the synthetic one."""
    device = resolve_device(device)
    fname = f"MANO_{side.upper()}.pkl"
    for root in ([mano_root] if mano_root else list(_DEFAULT_SEARCH)):
        path = os.path.join(root, fname)
        if os.path.exists(path):
            return load_mano_pkl(path, device)
    return synthetic_mano(side=side, device=device)


def _rotations(pose: torch.Tensor) -> torch.Tensor:
    """(B, 48) axis-angle -> (B, 16, 3, 3) rotations via the unit-quaternion formula."""
    B = pose.shape[0]
    aa = pose.reshape(B, 16, 3)
    sq = (aa * aa).sum(-1)
    angle = torch.sqrt(torch.clamp_min(sq, 1e-24))
    half = 0.5 * angle
    small = angle < 1e-6
    shoa = torch.where(small, 0.5 - sq / 48.0,
                       torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    w = torch.cos(half)
    x, y, z = (aa * shoa[..., None]).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1).reshape(B, 16, 3, 3)


def _chain(R: torch.Tensor, j_rest: torch.Tensor):
    """Root-to-leaf composition: R (B, 16, 3, 3), j_rest (B, 16, 3) -> world rotations
    (B, 16, 3, 3) and joint positions (B, 16, 3)."""
    rots = [R[:, 0]]
    trans = [j_rest[:, 0]]
    for k in range(1, NUM_JOINTS):
        p = PARENTS[k]
        rel = j_rest[:, k] - j_rest[:, p]
        trans.append((rots[p] @ rel[..., None])[..., 0] + trans[p])
        rots.append(rots[p] @ R[:, k])
    return torch.stack(rots, 1), torch.stack(trans, 1)


def _pose_map(R: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return (R[:, 1:] - eye).reshape(R.shape[0], 135)


def mano_fk(model: MANOModel, pose: torch.Tensor, shape: torch.Tensor):
    """pose (B, 48), shape (B, 10) -> verts (B, 778, 3) mm, joints (B, 21, 3) mm."""
    R = _rotations(pose)
    v_shaped = model.v_template + torch.einsum("vds,bs->bvd", model.shapedirs, shape)
    j_rest = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, _pose_map(R))
    A_rot, A_t = _chain(R, j_rest)
    corr_t = A_t - (A_rot @ j_rest[..., None])[..., 0]
    T_rot = torch.einsum("vk,bkij->bvij", model.weights, A_rot)
    T_t = torch.einsum("vk,bki->bvi", model.weights, corr_t)
    verts = (T_rot * v_posed[..., None, :]).sum(-1) + T_t
    jtr = torch.cat([A_t, verts[:, device_index(TIP_IDS, verts.device)]],
                    dim=1)[:, device_index(JOINT_REORDER, verts.device)]
    center = jtr[:, :1]
    return (verts - center) * 1000.0, (jtr - center) * 1000.0


def mano_fk_joints(model: MANOModel, pose: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
    """Joints-only FK (LBS restricted to the 5 fingertip vertices): (B, 21, 3) mm."""
    tips = device_index(TIP_IDS, pose.device)
    R = _rotations(pose)
    j_template = model.J_regressor @ model.v_template                       # (16, 3)
    jdirs = torch.einsum("jv,vds->jds", model.J_regressor, model.shapedirs)
    j_rest = j_template + torch.einsum("jds,bs->bjd", jdirs, shape)          # (B, 16, 3)
    A_rot, A_t = _chain(R, j_rest)
    corr = A_t - (A_rot @ j_rest[..., None])[..., 0]
    w_tips = model.weights[tips]                                            # (5, 16)
    T_rot = torch.einsum("vk,bkij->bvij", w_tips, A_rot)
    T_t = torch.einsum("vk,bki->bvi", w_tips, corr)
    v_tips = (model.v_template[tips]
              + torch.einsum("vds,bs->bvd", model.shapedirs[tips], shape)
              + torch.einsum("vdp,bp->bvd", model.posedirs[tips], _pose_map(R)))
    tip_pos = (T_rot * v_tips[..., None, :]).sum(-1) + T_t
    jtr = torch.cat([A_t, tip_pos], dim=1)[:, device_index(JOINT_REORDER, pose.device)]
    return (jtr - jtr[:, :1]) * 1000.0


def hand_joints_meters(model: MANOModel, pose: torch.Tensor, shape: torch.Tensor):
    lead = pose.shape[:-1]
    joints = mano_fk_joints(model, pose.reshape(-1, 48), shape.reshape(-1, 10))
    return joints.reshape(lead + (21, 3)) / 1000.0


def hand_verts_meters(model: MANOModel, pose: torch.Tensor, shape: torch.Tensor):
    lead = pose.shape[:-1]
    verts, joints = mano_fk(model, pose.reshape(-1, 48), shape.reshape(-1, 10))
    return (verts.reshape(lead + (NUM_VERTS, 3)) / 1000.0,
            joints.reshape(lead + (21, 3)) / 1000.0)
