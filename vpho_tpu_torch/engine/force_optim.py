"""Offline pseudo-force labels (counterpart of ``vpho_tpu/engine/force_optim.py``).

Per batch, two decision variables, ``scale`` (bs, 32) from 0.05 and ``weight`` (bs, 32, 8)
from 0, take ``TOTAL_ITERS`` steps of optax's ``adamw(1e-3)`` (the port's ``Optimizer``, decay
1e-4 after ``scale_by_adam``).  The first ``PHASE1_ITERS`` steps follow the gravity loss's
gradient with ``scale``'s zeroed (one optimizer over both, so ``scale``'s moments and decay still
run); the rest follow force + moment + contact distribution.  Ungrasped samples' forces are
zeroed, and ``save_force`` writes one ``hand_force_*.pkl`` {force_local, force_global} per frame,
which the loaders' ``get_force`` read at training time.

The loop runs on the inputs' device and never waits for it: the phase is a Python ``if`` on
the step.  The anchors' points and frames depend only on the ground-truth vertices, so they
are computed once per batch; ``_losses`` computes them itself, for a caller that has one
(scale, weight).

    python -m vpho_tpu_torch.engine.force_optim [the JAX CLI's flags]
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..models import anchor as anchor_lib
from ..models.heads import friction_anchor_dirs, local_force_from_scale_weight
from ..utils.transforms import flip_point3d
from .trainer import Optimizer

N_ANCHOR = 32
PHASE1_ITERS = 300
TOTAL_ITERS = 3000
LR = 1e-3


def _safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """A norm with a finite gradient at 0 (the eps stays under the root): a sample without
    contact has a moment of exactly 0."""
    return torch.sqrt((x * x).sum(dim) + eps)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """x over its detached norm along the last axis."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True).detach() + 1e-8)


def _forces(scale, weight, contact_mask, frame, dirs):
    s = scale * contact_mask
    force_local = local_force_from_scale_weight(s, weight, dirs=dirs)
    return s, force_local, anchor_lib.frames_to_global(frame, force_local)


def _gravity_loss(force_global, gravity):
    cos_proj = (force_global.sum(1, keepdim=True) * -gravity).sum(-1)
    return torch.mean((cos_proj - 1.0) ** 2)


def _balance_losses(s, force_global, force_point, fcn, contact_mask, gravity, com):
    """force, moment and contact-distribution losses (the moment and distribution terms are
    scaled by the detached force loss)."""
    resultant = force_global.sum(1, keepdim=True) + gravity
    force_loss = _safe_norm(resultant[:, 0]).mean()
    sum_weight = force_loss.detach()
    moment = torch.linalg.cross(force_point - com, force_global, dim=-1).sum(1)
    moment_loss = _safe_norm(moment).mean() * 30.0 / (100.0 * sum_weight ** 2 + 1e-8)
    dist = torch.log(torch.abs(fcn / (_unit_rows(s) + 1e-8)) + 1e-8) * contact_mask
    dist_loss = torch.mean(dist ** 2) * 0.1 / (1000.0 * sum_weight ** 2 + 1e-8)
    return force_loss, moment_loss, dist_loss


def _losses(scale, weight, contact_mask, force_contact, vert3d, gravity, com, tables):
    """The four loss terms at (scale, weight) and (force_local, force_point, force_global)."""
    force_point, frame = anchor_lib.anchor_points_and_frames(tables, vert3d)
    dirs = friction_anchor_dirs(8, 0.8, scale.device)
    s, force_local, force_global = _forces(scale, weight, contact_mask, frame, dirs)
    fl, ml, dl = _balance_losses(s, force_global, force_point, _unit_rows(force_contact),
                                 contact_mask, gravity, com)
    gl = _gravity_loss(force_global, gravity)
    return fl, gl, ml, dl, (force_local, force_point, force_global)


def optimize_forces(force_contact: torch.Tensor, vert3d: torch.Tensor, gravity: torch.Tensor,
                    com: torch.Tensor, tables: anchor_lib.ForceAnchorTables,
                    iters_phase1: int = PHASE1_ITERS,
                    iters_total: int = TOTAL_ITERS) -> Dict[str, object]:
    """The two-phase optimization of one batch on the inputs' device.

    force_contact (bs, 32); vert3d (bs, 778, 3) the flipped ground-truth vertices; gravity and
    com (bs, 1, 3).  Returns force_local / force_point / force_global (bs, 32, 3) and the final
    losses (0-d tensors)."""
    bs, dev = force_contact.shape[0], force_contact.device
    contact_mask = (force_contact > 0.1).float()
    scale = torch.full((bs, N_ANCHOR), 0.05, device=dev, requires_grad=True)
    weight = torch.zeros((bs, N_ANCHOR, 8), device=dev, requires_grad=True)
    opt = Optimizer({"scale": scale, "weight": weight}, "adamw", lambda step: LR)
    force_point, frame = anchor_lib.anchor_points_and_frames(tables, vert3d)
    dirs = friction_anchor_dirs(8, 0.8, dev)
    fcn = _unit_rows(force_contact)
    no_scale_grad = torch.zeros_like(scale)
    for i in range(iters_total):
        s, _, force_global = _forces(scale, weight, contact_mask, frame, dirs)
        if i < iters_phase1:
            (g_weight,) = torch.autograd.grad(_gravity_loss(force_global, gravity), [weight])
            grads = [no_scale_grad, g_weight]
        else:
            fl, ml, dl = _balance_losses(s, force_global, force_point, fcn, contact_mask,
                                         gravity, com)
            grads = list(torch.autograd.grad(fl + ml + dl, [scale, weight]))
        opt.step(grads)
    with torch.no_grad():
        fl, gl, ml, dl, (force_local, force_point, force_global) = _losses(
            scale, weight, contact_mask, force_contact, vert3d, gravity, com, tables)
    return {"force_local": force_local, "force_point": force_point,
            "force_global": force_global,
            "losses": {"force": fl, "gravity": gl, "moment": ml, "dist": dl}}


class ForceOptimizer:
    """Batch runner: the flip protocol, the optimization, the zeroing of ungrasped samples, and
    the per-frame label files."""

    def __init__(self, tables: anchor_lib.ForceAnchorTables):
        self.tables = tables

    def run_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, object]:
        """A host batch (the loaders' keys) -> numpy force_local / force_global / force_point
        (bs, 32, 3) and the final losses as floats."""
        dev = self.tables.face_vert_idx.device
        f32 = lambda k: torch.as_tensor(np.asarray(batch[k], np.float32), device=dev)
        is_right = torch.as_tensor(np.asarray(batch["is_right"]).astype(bool), device=dev)
        # gravity and CoM into the right-hand frame of the flipped vertices
        gravity = flip_point3d(f32("gravity"), ~is_right)
        com = flip_point3d(f32("obj_CoM"), ~is_right)
        out = optimize_forces(f32("force_contact"), f32("gt_hand_vert_flip"), gravity, com,
                              self.tables, PHASE1_ITERS, TOTAL_ITERS)
        grasp = torch.as_tensor(np.asarray(batch["is_grasped"]).astype(bool),
                                device=dev)[:, None, None]
        return {"force_local": torch.where(grasp, out["force_local"], 0.0).cpu().numpy(),
                "force_global": torch.where(grasp, out["force_global"], 0.0).cpu().numpy(),
                "force_point": out["force_point"].cpu().numpy(),
                "losses": {k: float(v) for k, v in out["losses"].items()}}

    @staticmethod
    def save_force(result: Dict[str, np.ndarray], rgb_paths, dataset_name="dexycb"):
        """One pkl per frame, beside the JAX package's: DexYCB's under ``DexYCB/cache/
        hand_force/``, HO3D's under ``HO3D_v2/cache/hand_force/``.  A path without that
        directory name is written beside the frame."""
        for i, p in enumerate(rgb_paths):
            if dataset_name == "dexycb":
                save_path = p.replace("DexYCB/", "DexYCB/cache/hand_force/") \
                             .replace(".jpg", ".pkl").replace("color_", "hand_force_")
            elif dataset_name == "ho3d":
                save_path = p.replace("HO3D_v2/", "HO3D_v2/cache/hand_force/") \
                             .replace(".png", ".pkl").replace("rgb/", "hand_force/")
            else:
                raise NotImplementedError(dataset_name)
            os.makedirs(os.path.dirname(save_path), exist_ok=True)
            with open(save_path, "wb") as f:
                pickle.dump({"force_local": result["force_local"][i],
                             "force_global": result["force_global"][i]}, f)


if __name__ == "__main__":
    from ..cli import force_optim_main

    force_optim_main()
