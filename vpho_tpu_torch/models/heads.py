"""Regression heads, cross-attention module, physics head and the object layer (counterpart
of ``vpho_tpu/models/heads.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..utils import transforms as T
from .layers import Conv2d, DropoutMasks, TransformerEncoderLayer, nerf_embed, sinusoid_table
from .ycb import YCBRegistry


class HeadMano(nn.Module):
    """1024 -> 1024 -> 512 (LeakyReLU) -> 16 rot6d pose (returned as axis-angle) + 10 shape."""

    def __init__(self, in_dim: int = 1024):
        super().__init__()
        self.base_layer = nn.Sequential(nn.Linear(in_dim, 1024), nn.LeakyReLU(0.01),
                                        nn.Linear(1024, 512), nn.LeakyReLU(0.01))
        self.fc_pose = nn.Linear(512, 16 * 6)
        self.fc_shape = nn.Linear(512, 10)

    def forward(self, x):
        h = self.base_layer(x)
        pose6d = self.fc_pose(h).reshape(x.shape[0], 16, 6)
        pose_aa = T.matrix_to_axis_angle(T.rotation_6d_to_matrix(pose6d)).reshape(x.shape[0], 48)
        return pose_aa, self.fc_shape(h)


def mano_losses(pd_pose, pd_shape, pd_vert, pd_joint, gt_pose, gt_shape, gt_vert, gt_joint,
                is_right) -> Dict[str, torch.Tensor]:
    """Vertex and joint MSE, the pose loss in rot6d space, and the shape loss over right hands
    only, rescaled by the right-hand count over the batch (as the reference does)."""
    right = is_right.to(pd_shape.dtype)[:, None]
    n_right = torch.clamp_min(right.sum(), 1.0)
    shape_mse = (((pd_shape - gt_shape) ** 2) * right).sum() / (n_right * pd_shape.shape[-1])
    return {
        "vert_loss": torch.mean((pd_vert - gt_vert) ** 2),
        "joint_loss": torch.mean((pd_joint - gt_joint) ** 2),
        "mano_pose_loss": torch.mean((T.mano_aa_to_6d(pd_pose) - T.mano_aa_to_6d(gt_pose)) ** 2),
        "mano_shape_loss": shape_mse / pd_shape.shape[0] * n_right,
    }


def object_points(registry: YCBRegistry, obj_ids: torch.Tensor, data_name: str) -> torch.Tensor:
    """The per-object point set, (B, V, 3), by 0-based id."""
    pts = {"keypoint": registry.kpt3d, "verts": registry.verts_sampled,
           "CoM": registry.com[:, None, :]}[data_name]
    return pts[obj_ids.long()]


def object_transform(registry: YCBRegistry, pose9d: torch.Tensor, obj_ids: torch.Tensor,
                     data_name: str = "keypoint") -> torch.Tensor:
    """Apply rot6d + translation poses to the canonical points: pose9d (B, ..., 9) ->
    (B, ..., V, 3)."""
    B = pose9d.shape[0]
    pts = object_points(registry, obj_ids, data_name)                   # (B, V, 3)
    rot = T.rotation_6d_to_matrix(pose9d[..., :6]).reshape(B, -1, 3, 3)  # (B, M, 3, 3)
    new = torch.einsum("bvi,bmji->bmvj", pts, rot)
    new = new.reshape(pose9d.shape[:-1] + pts.shape[1:])
    return new + pose9d[..., None, 6:]


def flip_pt3d(pt3d: torch.Tensor, is_right: torch.Tensor) -> torch.Tensor:
    """Mirror x for left-hand samples."""
    return T.flip_point3d(pt3d, ~is_right)


def to_axsym_pose(registry: YCBRegistry, pose: torch.Tensor, obj_ids: torch.Tensor) -> torch.Tensor:
    """Reframe a (B, 9) camera pose into the object's axial-symmetry frame."""
    shift = registry.shift[obj_ids.long()]                              # (B, 3, 4)
    inv_r = shift[..., :3, :3].transpose(-1, -2)
    inv_t = -T.matmul_f32(inv_r, shift[..., :3, 3:])
    return T.obj_mat_to_9d(T.matmul_for_rt(T.obj_9d_to_mat(pose), torch.cat([inv_r, inv_t], -1)))


def to_cam_pose(registry: YCBRegistry, pose: torch.Tensor, obj_ids: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_axsym_pose``."""
    shift = registry.shift[obj_ids.long()]
    return T.obj_mat_to_9d(T.matmul_for_rt(T.obj_9d_to_mat(pose), shift))


class CrossModule(nn.Module):
    """Hand/object token exchange with a gravity token.

    The (B, 256, 8, 8) encoder maps are 3x3-conv projected and grouped channel-major into 32
    tokens each; a 1-layer post-norm transformer mixes [hand(32) | obj(32) | gravity(1)].
    ``attention_axis`` "tokens" attends over the 65 tokens (DEVIATIONS.md D1); "batch" replays
    the reference's sequence-first feed, which attends across samples.  In train mode the
    tokens pass a dropout after the positional table, then the layer's four (masks from
    ``dropout``, torch's default generator when None).
    """

    def __init__(self, in_ch: int = 256, hid_dim: int = 512, num_force: int = 32,
                 spatial: int = 64, attention_axis: str = "tokens", compute_dtype=None):
        super().__init__()
        if attention_axis not in ("tokens", "batch"):
            raise ValueError(f"attention_axis must be tokens|batch, got {attention_axis!r}")
        self.hid_dim, self.num_force, self.attention_axis = hid_dim, num_force, attention_axis
        proj_dim = int(hid_dim / (spatial / num_force))
        self.proj_hand = Conv2d(in_ch, proj_dim, 3, padding=1, compute_dtype=compute_dtype)
        self.proj_obj = Conv2d(in_ch, proj_dim, 3, padding=1, compute_dtype=compute_dtype)
        self.gravity_proj = nn.Linear(63, hid_dim)
        self.attn = nn.Module()
        self.attn.layers = nn.ModuleList([TransformerEncoderLayer(hid_dim, 2,
                                                                  compute_dtype=compute_dtype)])

    def forward(self, x_hand, x_obj, gravity, dropout: Optional[DropoutMasks] = None):
        B = x_hand.shape[0]
        tok_h = self.proj_hand(x_hand).reshape(B, self.num_force, self.hid_dim)
        tok_o = self.proj_obj(x_obj).reshape(B, self.num_force, self.hid_dim)
        if gravity.dim() == 2:
            gravity = gravity[:, None, :]
        g = self.gravity_proj(nerf_embed(gravity, multires=10))
        x = torch.cat([tok_h.float(), tok_o.float(), g], dim=1)             # (B, 65, hid)
        layer = self.attn.layers[0]
        if self.training and dropout is None:
            dropout = DropoutMasks()
        if self.attention_axis == "batch":
            x = x + sinusoid_table(B, self.hid_dim, x.device)[:, None]
            x = dropout(x) if self.training else x
            x = layer(x.transpose(0, 1), dropout).transpose(0, 1)
        else:
            x = x + sinusoid_table(x.shape[1], self.hid_dim, x.device)[None]
            x = dropout(x) if self.training else x
            x = layer(x, dropout)
        x = x.float()
        return x[:, :self.num_force], x[:, self.num_force:2 * self.num_force], x[:, 2 * self.num_force:]


def friction_anchor_dirs(num_anchor: int = 8, friction_coeff: float = 0.8, device=None):
    """(8, 3) friction-cone anchor directions."""
    ang = torch.arange(num_anchor, dtype=torch.float32, device=device) * (2 * math.pi / num_anchor)
    anchor = torch.stack([torch.cos(ang), torch.sin(ang), torch.ones_like(ang)], dim=-1) / num_anchor
    return anchor * torch.tensor([friction_coeff, friction_coeff, 1.0], device=device)


def local_force_from_scale_weight(scale: torch.Tensor, weight: torch.Tensor,
                                  friction_coeff: float = 0.8,
                                  dirs: torch.Tensor | None = None) -> torch.Tensor:
    """force = normalize(softmax(weight) @ anchor dirs) * |scale| (the reference softmaxes
    the weight twice; kept).  ``dirs``: ``friction_anchor_dirs(8, friction_coeff)`` made
    once by a caller that runs this in a loop (building it copies from the host)."""
    weight = torch.softmax(weight, dim=-1)
    if dirs is None:
        dirs = friction_anchor_dirs(8, friction_coeff, weight.device)
    direction = weight @ dirs
    return T.normalize(direction) * scale.abs()[..., None]


def _mlp(in_dim: int, hid_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(in_dim, hid_dim), nn.LeakyReLU(0.01), nn.Linear(hid_dim, out_dim))


class HeadPhysics(nn.Module):
    """Per-anchor contact force and object CoM from the cross-module tokens."""

    def __init__(self, hid_dim: int = 512):
        super().__init__()
        self.fc_scale = _mlp(hid_dim, hid_dim, 1)
        self.fc_weight = _mlp(hid_dim, hid_dim, 8)
        self.fc_CoM = _mlp(hid_dim, hid_dim, 3)

    def forward(self, x_hand, x_obj):
        scale = self.fc_scale(x_hand)[..., 0]
        weight = torch.softmax(self.fc_weight(x_obj), dim=-1)
        com = self.fc_CoM(x_obj)
        return {"force_local": local_force_from_scale_weight(scale, weight), "scale": scale,
                "weight": weight, "CoM": com}


def physics_losses(gt_force_point, pd_force_global, gt_com, pd_com, gt_force_local,
                   pd_force_local, gt_gravity, is_grasped) -> Dict[str, torch.Tensor]:
    """Force balance, gravity alignment, torque balance, supervised local force and CoM
    losses.  gt_gravity (B, 1, 3); is_grasped (B,); pd_com (B, 32, 3).  |x|^2 is written as
    sum(x^2): the gradient of a norm is NaN at exactly 0."""
    grasp = is_grasped.to(pd_force_global.dtype)
    total = pd_force_global.sum(1, keepdim=True)                        # (B, 1, 3)
    resultant = total + gt_gravity
    force_loss = torch.mean((resultant ** 2).sum(-1)[:, 0] * grasp ** 2)
    cos_proj = (total * gt_gravity).sum(-1)[:, 0]
    gravity_loss = torch.mean(((cos_proj + 1.0) * grasp) ** 2)
    arm = gt_force_point - gt_com                                       # (B, 32, 3)
    torque = torch.linalg.cross(arm, pd_force_global, dim=-1).sum(1)
    torque_loss = torch.mean((torque ** 2).sum(-1) * grasp ** 2)
    return {
        "force_loss": force_loss,
        "gravity_loss": gravity_loss,
        "torque_loss": torque_loss,
        "supervised_loss": torch.mean((pd_force_local - gt_force_local) ** 2),
        "CoM_loss": torch.mean((pd_com - gt_com.expand(pd_com.shape)) ** 2),
    }
