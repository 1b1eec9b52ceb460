"""Batched evaluation metrics, hand and object (counterpart of
``vpho_tpu/engine/metrics.py``): the same criteria, formulas and units (meters in, the tester
formats mm).

Object: MCE, MCE2, OCE, ADD, ADD-S, ADD-0.1d, ADDS-0.1d, REP, REP5, F-score at
{2, 5, 10 mm, 2, 5, 10 cm} and Chamfer-L2.  Hand: MJE, PA-MJE, MVE, PA-MVE and per-joint JE.

Arithmetic.  The nearest-point distances expand |a - b|^2 as |a|^2 + |b|^2 - 2 a.b, as the
reference does, and that form cancels: a point 0.6 m from the camera carries |a|^2 ~ 0.36, so
one rounding of a 3-term dot product moves d^2 by ~3e-8 m^2, which is 2e-4 m on a distance
near zero and moves points across the F-score thresholds.  So every 3-term dot product here
(point transforms, projections and the distance expansion) is ``dot3`` (``ops/metric_nn.py``):
the first product, then two fused multiply-adds, each exact product rounded once.  That is the
rounding of the JAX package's CPU arithmetic, so the port reproduces its numbers, and it is
plain elementwise arithmetic on every device: no matmul, whatever the TF32 flags say.  Plain
PyTorch has no float32 FMA, so ``dot3`` emulates it in float64.  The (P, Q) distance blocks are
the one place where that costs: on a card ``pairwise_min_dist`` launches K3
(``ops/metric_nn.py``, ``csrc/metric_nn.cu``), which rounds with the card's own FMA in float32,
keeps every pair in registers and gives the plain form's numbers; on the CPU it builds the
plain form's blocks a few samples at a time (``chunk``) to bound peak memory, and the chunk
changes no result.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch

from ..models.ycb import YCBRegistry
from ..ops import metric_nn as K3
from ..ops.metric_nn import dot3
from ..utils import transforms as T
from ..utils.platform import device_index

# the 8 bbox corners inside the 27-point lattice (i, j, k in {0, 2} of the 3x3x3 grid)
BBOX8_IN_KPT27 = [0, 2, 6, 8, 18, 20, 24, 26]

FSCORE_THRESHOLDS = (0.002, 0.005, 0.010, 0.020, 0.050, 0.100)
FSCORE_KEYS = ("FSCORE@2mm", "FSCORE@5mm", "FSCORE@10mm",
               "FSCORE@2cm", "FSCORE@5cm", "FSCORE@10cm")


def _apply_rt(pts: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3), rt (..., 3, 4) -> R pts + t."""
    return dot3(pts[..., :, None, :], rt[..., None, :, :3]) + rt[..., None, :, 3]


def _project(pts: torch.Tensor, cam_intr: torch.Tensor) -> torch.Tensor:
    """pts (N, P, 3), cam_intr (N, 3, 3) -> (N, P, 2), each sample with its own camera."""
    uvw = dot3(pts[..., :, None, :], cam_intr[:, None])
    return uvw[..., :2] / uvw[..., 2:]


def pairwise_min_dist(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None,
                      chunk: int | None = None):
    """Nearest-point distances both ways between a (N, P, 3) and b (N, Q, 3): returns
    (min over b for each a (N, P), min over a for each b (N, Q)).  ``mask`` (N, P == Q) marks
    the real points of both sets (mesh padding is skipped).  K3 on a card, the plain form
    (``chunk`` samples a block) on the CPU: ``ops/metric_nn.py::nearest``."""
    return K3.nearest(a, b, mask, chunk)


def hand_metrics(gt_joint, pd_joint, gt_vert, pd_vert) -> Dict[str, torch.Tensor]:
    """Per-sample hand criteria (meters).  Joints (N, 21, 3); verts (N, 778, 3)."""
    je = torch.linalg.norm(gt_joint - pd_joint, dim=-1)                  # (N, 21)
    pa_mje = torch.linalg.norm(gt_joint - T.rigid_align(pd_joint, gt_joint), dim=-1).mean(-1)
    ve = torch.linalg.norm(gt_vert - pd_vert, dim=-1)
    pa_mve = torch.linalg.norm(gt_vert - T.rigid_align(pd_vert, gt_vert), dim=-1).mean(-1)
    return {"MJE": je.mean(-1), "PA_MJE": pa_mje, "JE": je, "MVE": ve.mean(-1), "PAMVE": pa_mve}


def load_bop_symmetries(path: str = "asset/2023_NIPS_DeepSimHO/assets_models_info.json",
                        max_sym_disc_step: float = 0.01):
    """BOP symmetry transform banks per YCB class: (R (21, S, 3, 3), t (21, S, 3)) numpy
    arrays padded with identities; identity only when the asset json is absent (then SMCE
    equals MCE)."""
    if not os.path.exists(path):
        return np.tile(np.eye(3), (21, 1, 1, 1)), np.zeros((21, 1, 3))
    with open(path) as f:
        info = json.load(f)
    banks = []
    for obj_idx in range(1, 22):
        mi = info[str(obj_idx)]
        trans_disc = [(np.eye(3), np.zeros(3))]
        for sym in mi.get("symmetries_discrete", []):
            m = np.reshape(sym, (4, 4))
            trans_disc.append((m[:3, :3], m[:3, 3]))
        trans_cont = []
        for sym in mi.get("symmetries_continuous", []):
            axis = np.asarray(sym["axis"], float)
            offset = np.asarray(sym["offset"], float)
            steps = int(np.ceil(np.pi / max_sym_disc_step))
            dstep = 2 * np.pi / steps
            for i in range(1, steps):
                ang = i * dstep
                k = axis / np.linalg.norm(axis)
                K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
                Rr = np.eye(3) + math.sin(ang) * K + (1 - math.cos(ang)) * (K @ K)
                trans_cont.append((Rr, -Rr @ offset + offset))
        bank = []
        for Rd, td in trans_disc:
            if trans_cont:
                bank.extend((Rc @ Rd, Rc @ td + tc) for Rc, tc in trans_cont)
            else:
                bank.append((Rd, td))
        banks.append(bank)
    S = max(len(b) for b in banks)
    R = np.tile(np.eye(3), (21, S, 1, 1))
    t = np.zeros((21, S, 3))
    for i, b in enumerate(banks):
        for j, (Rj, tj) in enumerate(b):
            R[i, j] = Rj
            t[i, j] = tj / 1000.0                                        # mm -> m
    return R, t


def smce(registry: YCBRegistry, sym_R, sym_t, pd_rt, gt_rt, obj_ids) -> torch.Tensor:
    """Symmetry-aware MCE: the least bbox-corner error over the symmetry transforms."""
    ids = obj_ids.long()
    bbox8 = registry.kpt3d[ids][:, BBOX8_IN_KPT27]                       # (N, 8, 3)
    R = torch.as_tensor(sym_R, dtype=torch.float32, device=pd_rt.device)[ids]   # (N, S, 3, 3)
    t = torch.as_tensor(sym_t, dtype=torch.float32, device=pd_rt.device)[ids]   # (N, S, 3)
    sym_b = dot3(bbox8[:, None, :, None, :], R[:, :, None]) + t[:, :, None]     # (N, S, 8, 3)
    gt_b = _apply_rt(sym_b, gt_rt[:, None])
    pd_b = _apply_rt(bbox8, pd_rt)
    return torch.linalg.norm(pd_b[:, None] - gt_b, dim=-1).mean(-1).amin(-1)


_AABB_CORNERS = ((0, 1, 0, 0, 1, 0, 1, 1), (0, 0, 1, 0, 1, 1, 0, 1), (0, 0, 0, 1, 0, 1, 1, 1))


def _aabb_corners(v: torch.Tensor) -> torch.Tensor:
    mm = torch.stack([v.amin(-2), v.amax(-2)], dim=-2)                   # (N, 2, 3)
    ci = [device_index(c, v.device) for c in _AABB_CORNERS]
    return torch.stack([mm[:, ci[0], 0], mm[:, ci[1], 1], mm[:, ci[2], 2]], dim=-1)


def object_metrics(registry: YCBRegistry, pd_rt, gt_rt, obj_ids, cam_intr,
                   chunk: int | None = None) -> Dict[str, torch.Tensor]:
    """Per-sample object criteria.  pd_rt / gt_rt (N, 3, 4) camera frame; obj_ids (N,)
    0-based; cam_intr (N, 3, 3).  REP projects each sample with its own camera."""
    ids = obj_ids.long()
    bbox8 = registry.kpt3d[ids][:, device_index(BBOX8_IN_KPT27, ids.device)]
    vs = registry.verts_sampled[ids]
    vf = registry.verts_full[ids]
    vmask = registry.verts_full_mask[ids]
    diameter = registry.diameter[ids]

    pd_b, gt_b = _apply_rt(bbox8, pd_rt), _apply_rt(bbox8, gt_rt)
    mce = torch.linalg.norm(pd_b - gt_b, dim=-1).mean(-1)
    oce = torch.linalg.norm(pd_b.mean(-2) - gt_b.mean(-2), dim=-1)

    pd_v, gt_v = _apply_rt(vs, pd_rt), _apply_rt(vs, gt_rt)
    add = torch.linalg.norm(pd_v - gt_v, dim=-1).mean(-1)
    adds = pairwise_min_dist(pd_v, gt_v, chunk=chunk)[0].mean(-1)
    rep = torch.linalg.norm(_project(pd_v, cam_intr) - _project(gt_v, cam_intr), dim=-1).mean(-1)
    mce2 = torch.linalg.norm(_aabb_corners(pd_v) - _aabb_corners(gt_v), dim=-1).mean(-1)

    # F-score and Chamfer on the full meshes, padding masked out
    d_p2g, d_g2p = pairwise_min_dist(_apply_rt(vf, pd_rt), _apply_rt(vf, gt_rt), vmask, chunk)
    cnt = vmask.sum(-1)

    def masked_mean(x):
        return (x * vmask).sum(-1) / cnt

    out = {
        "MCE": mce, "MCE2": mce2, "OCE": oce, "ADD": add, "ADDS": adds, "REP": rep,
        "CD": 0.5 * (masked_mean(d_p2g) + masked_mean(d_g2p)),
        "ADD01d": (add <= diameter * 0.1).float(),
        "ADDS01d": (adds <= diameter * 0.1).float(),
        "REP5": (rep < 5.0).float(),
    }
    for th, key in zip(FSCORE_THRESHOLDS, FSCORE_KEYS):
        precision = masked_mean((d_p2g < th).float())
        recall = masked_mean((d_g2p < th).float())
        out[key] = (2 * precision * recall) / (precision + recall + 1e-6)
    return out
