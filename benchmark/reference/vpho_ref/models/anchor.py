"""32-anchor contact force frames on the MANO mesh (counterpart of
``vpho_tpu/models/anchor.py``).

Each anchor sits on a mesh triangle (barycentric combination of 3 vertices) with a local frame
built from the triangle normal and the downstream bone direction.  Tables come from the CPF
asset files when present, else the same seeded synthetic layout as the JAX package.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..utils import transforms as T
from ..utils.hand import SKELETON_LEVEL, build_vert2joint
from ..utils.platform import resolve_device
from .mano import MANOModel

_LABEL_LEVEL = {
    "WIM": [5], "WMM": [12], "WRM": [19, 18], "WPM": [26, 25],
    "MTP": [6, 0], "MIP": [7], "MMP": [13], "MRP": [20], "MPP": [27],
    "PTD": [1], "PID": [8], "PMD": [14], "PRD": [21], "PPD": [28],
    "DTT": [2, 3, 4], "DIT": [9, 11, 10], "DMT": [15, 17, 16],
    "DRT": [22, 24, 23], "DPT": [29, 31, 30],
}

# the anchors of the six hand regions: palm, thumb, index, middle, ring, pinky
_FINGER_GROUPS = tuple(sum((_LABEL_LEVEL[k] for k in keys), []) for keys in (
    ("WIM", "WMM", "WRM", "WPM"), ("MTP", "PTD", "DTT"), ("MIP", "PID", "DIT"),
    ("MMP", "PMD", "DMT"), ("MRP", "PRD", "DRT"), ("MPP", "PPD", "DPT")))


def _corresponding_skeleton() -> np.ndarray:
    """(32, 2) skeleton edge per anchor id."""
    S = SKELETON_LEVEL
    rows = [
        S[0][1], S[0][2], S[0][3], S[0][3], S[0][4], S[0][4],
        S[0][0], S[0][0], S[1][1], S[1][2], S[1][3], S[1][4],
        S[2][0], S[2][1], S[2][2], S[2][3], S[2][4],
        S[3][0], S[3][0], S[3][0],
        S[3][1], S[3][1], S[3][1],
        S[3][2], S[3][2], S[3][2],
        S[3][3], S[3][3], S[3][3],
        S[3][4], S[3][4], S[3][4],
    ]
    labels = np.array([lab for v in _LABEL_LEVEL.values() for lab in v])
    return np.stack(rows, axis=0)[np.argsort(labels)]


class ForceAnchorTables(NamedTuple):
    face_vert_idx: torch.Tensor    # (32, 3) int64 vertex ids
    anchor_weight: torch.Tensor    # (32, 3) barycentric (ones column prepended)
    skeleton: torch.Tensor         # (32, 2) int64 joint-id pairs for the y direction
    vert2joint: torch.Tensor       # (21, 778)


def load_anchor_tables(mano: MANOModel, asset_path: str = "asset/2021_CVPR_CPF",
                       device=None) -> ForceAnchorTables:
    """The force-anchor tables on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    anchor_root = os.path.join(asset_path, "anchor")
    fvi_path = os.path.join(anchor_root, "face_vertex_idx.txt")
    aw_path = os.path.join(anchor_root, "anchor_weight.txt")
    if os.path.exists(fvi_path) and os.path.exists(aw_path):
        face_vert_idx = np.loadtxt(fvi_path, dtype=np.int32)
        anchor_weight = np.loadtxt(aw_path)
    else:
        rng = np.random.RandomState(7)
        face_vert_idx = rng.randint(0, 778, size=(32, 3)).astype(np.int32)
        anchor_weight = rng.rand(32, 2) * 0.5
    anchor_weight = np.concatenate([np.ones([anchor_weight.shape[0], 1]), anchor_weight], axis=1)
    v2j = build_vert2joint(mano.J_regressor.cpu().numpy())
    return ForceAnchorTables(
        face_vert_idx=torch.as_tensor(face_vert_idx.astype(np.int64), device=device),
        anchor_weight=torch.as_tensor(anchor_weight.astype(np.float32), device=device),
        skeleton=torch.as_tensor(_corresponding_skeleton().astype(np.int64), device=device),
        vert2joint=torch.as_tensor(v2j, device=device),
    )


def anchor_points_and_frames(tables: ForceAnchorTables, verts: torch.Tensor):
    """verts (..., 778, 3) -> anchors (..., 32, 3), frames (..., 32, 3, 3) whose columns are
    the local x, y, z axes."""
    tri = verts[..., tables.face_vert_idx.reshape(-1), :].reshape(verts.shape[:-2] + (32, 3, 3))
    b1 = tri[..., 1, :] - tri[..., 0, :]
    b2 = tri[..., 2, :] - tri[..., 0, :]
    joints = torch.einsum("...vd,jv->...jd", verts, tables.vert2joint)
    y_raw = joints[..., tables.skeleton[:, 1], :] - joints[..., tables.skeleton[:, 0], :]
    z = T.normalize(torch.linalg.cross(b1, b2, dim=-1))
    y = T.normalize(y_raw)
    x = torch.linalg.cross(y, z, dim=-1)
    y = T.normalize(torch.linalg.cross(z, x, dim=-1))
    frames = torch.stack([x, y, z], dim=-1)
    w = tables.anchor_weight
    anchors = w[:, 1:2] * b1 + w[:, 2:3] * b2 + tri[..., 0, :]
    return anchors, frames


def force_local_to_global(tables: ForceAnchorTables, force_local: torch.Tensor,
                          verts: torch.Tensor):
    """Returns (force_point, force_global), each (..., 32, 3)."""
    point, frame = anchor_points_and_frames(tables, verts)
    return point, frames_to_global(frame, force_local)


def frames_to_global(frame: torch.Tensor, force_local: torch.Tensor) -> torch.Tensor:
    """(..., 32, 3, 3) anchor frames and (..., 32, 3) forces in them -> the camera frame."""
    return (frame * force_local[..., None, :]).sum(-1)


def force_local_to_global_np(tables: ForceAnchorTables, force_local, verts):
    """Host (numpy, float64 inside) twin of ``force_local_to_global`` for one sample:
    force_local (32, 3), verts (778, 3) -> (force_point, force_global), each (32, 3) float32."""
    fvi = tables.face_vert_idx.cpu().numpy().reshape(-1)
    verts = np.asarray(verts, np.float64)
    tri = verts[fvi].reshape(32, 3, 3)
    b1, b2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    joints = np.einsum("vd,jv->jd", verts, tables.vert2joint.cpu().numpy())
    skel = tables.skeleton.cpu().numpy()
    y_raw = joints[skel[:, 1]] - joints[skel[:, 0]]

    def nrm(v, eps=1e-8):
        return v / (np.sqrt((v * v).sum(-1, keepdims=True)) + eps)

    z = nrm(np.cross(b1, b2))
    x = np.cross(nrm(y_raw), z)
    y = nrm(np.cross(z, x))
    frame = np.stack([x, y, z], axis=-1)                                  # (32, 3, 3)
    w = tables.anchor_weight.cpu().numpy()
    point = w[:, 1:2] * b1 + w[:, 2:3] * b2 + tri[:, 0]
    force_global = np.einsum("bi,bji->bj", np.asarray(force_local, np.float64), frame)
    return point.astype(np.float32), force_global.astype(np.float32)


def force_global_to_local(tables: ForceAnchorTables, force_global: torch.Tensor,
                          verts: torch.Tensor) -> torch.Tensor:
    """(..., 32, 3) camera-frame forces -> anchor frames, through the frames' transpose.  The x
    axis is not unit (y x z, never renormalized), so a round trip scales x by |x|^2."""
    _, frame = anchor_points_and_frames(tables, verts)
    return (frame.transpose(-1, -2) * force_global[..., None, :]).sum(-1)


def pool_contact_to_anchors_np(tables: ForceAnchorTables, hand_contact) -> np.ndarray:
    """(..., 778) per-vertex contact -> (..., 32) anchor contact, the barycentric mean over
    each anchor's triangle (numpy, for the data loaders)."""
    fvi = tables.face_vert_idx.cpu().numpy().reshape(-1)
    w = tables.anchor_weight.cpu().numpy()
    fc = np.asarray(hand_contact)[..., fvi].reshape(np.shape(hand_contact)[:-1] + (32, 3))
    return (fc * (w / w.sum(axis=1, keepdims=True))).sum(-1)


def check_is_grasped_np(force_contact, thresh: float = 0.0) -> bool:
    """(32,) anchor contact -> whether at least 2 of the 6 hand regions touch."""
    fc = np.asarray(force_contact)
    return sum(int(fc[list(g)].sum() > thresh) for g in _FINGER_GROUPS) >= 2
