"""Conditional score network (counterpart of ``vpho_tpu/models/denoiser.py``).

  t --GaussianFourier(128)--Linear--ReLU--> 128
  sampled_pose --Linear(256)-ReLU-Linear(256)-ReLU--> 256
  [t(128) | pose(256) | feat(1024)] --> bank head (n banks x (1408 -> 256 -> 3)) --> out / std

The bank head's first layer is linear, so inside the ODE loop the constant conditioning term
``feat @ W1[:, 384:]`` is projected once per sample (``precompute_feat``) and the shared step
time ``t`` arrives with batch 1.  Under the bf16 policy, with one shared ``t`` and
``num * out >= 32`` (the 32-bank hand head, not the 3-bank object head), the head runs as the
fused kernel K1 (``ops/bank_mlp.py``), whose constant operands ``prepare_fused`` makes once
per ODE solve; otherwise it is two einsums.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn as nn

from ..ops.bank_mlp import BankWeights, bank_mlp_prepared, prepare
from ..precision import to_compute

T_DIM = 128
POSE_DIM = 256
FEAT_DIM = 1024
TP_DIM = T_DIM + POSE_DIM
TOTAL_FEAT_DIM = TP_DIM + FEAT_DIM

HEAD_OUT_DIM = {"mano_pose": 96, "obj": 9}
HEAD_BANKS = {"mano_pose": 32, "obj": 3}


class FusedOperands(NamedTuple):
    """What K1's call site keeps over an ODE solve: the kernel's weights, the bf16 t-slice of
    W1, and ``add0`` = bias1 + the conditioning projection (B, num, hidden) in f32."""

    weights: BankWeights
    w_t: torch.Tensor
    add0: torch.Tensor


class ParallelLinear(nn.Module):
    """A bank of ``num`` independent linear layers: weight (num, in, out), bias (num, out)."""

    def __init__(self, in_features: int, out_features: int, num: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(num, out_features))


class BankMLPHead(nn.Module):
    """``ParallelLinear(1408, 256, num) -> ReLU -> ParallelLinear(256, out_dim, num)`` with a
    splittable first layer.  Keys ``head.0.*`` / ``head.2.*`` as in the reference."""

    def __init__(self, num: int, out_dim: int = 3, hidden: int = 256, compute_dtype=None):
        super().__init__()
        self.num, self.out_dim, self.compute_dtype = num, out_dim, compute_dtype
        self.head = nn.ModuleList([ParallelLinear(TOTAL_FEAT_DIM, hidden, num), nn.ReLU(),
                                   ParallelLinear(hidden, out_dim, num)])

    def _cast(self, *xs):
        if self.compute_dtype is None:
            return xs
        return tuple(to_compute(x, self.compute_dtype) for x in xs)

    def precompute_feat(self, feat: torch.Tensor) -> torch.Tensor:
        """feat (B, 1024) -> (B, num, hidden): the constant first-layer term."""
        feat, w = self._cast(feat, self.head[0].weight[:, TP_DIM:])
        return torch.einsum("bc,ncd->bnd", feat, w)

    @property
    def runs_k1(self) -> bool:
        """Whether the ODE fast path runs as K1: bf16 policy and a wide head (the 32-bank
        hand head, not the 3-bank object head)."""
        return self.compute_dtype is not None and self.num * self.out_dim >= 32

    def prepare_fused(self, feat_proj: torch.Tensor) -> FusedOperands:
        """K1's operands that stay fixed over an ODE solve, made once per forward."""
        l1, l2 = self.head[0], self.head[2]
        return FusedOperands(prepare(l1.weight[:, T_DIM:TP_DIM], l2.weight, l2.bias),
                             to_compute(l1.weight[:, :T_DIM], torch.bfloat16),
                             (l1.bias + feat_proj.float()).contiguous())

    def fused_inputs(self, t_feat, pose_feat, fused: FusedOperands):
        """The per-step operands of K1: p, and ``add`` with the shared t-embedding folded in."""
        t_term = torch.einsum("bc,ncd->bnd", to_compute(t_feat, torch.bfloat16), fused.w_t)
        return to_compute(pose_feat, torch.bfloat16).contiguous(), t_term.float() + fused.add0

    def forward(self, t_feat: torch.Tensor, pose_feat: torch.Tensor,
                feat: torch.Tensor | None = None,
                feat_proj: torch.Tensor | None = None,
                fused: FusedOperands | None = None) -> torch.Tensor:
        """t_feat (Bt, 128) with Bt in {1, B}; pose_feat (B, 256); either the raw ``feat``
        (B, 1024) or a per-sample ``feat_proj`` (B or B/S, num, hidden).  ``fused`` holds
        K1's operands from :meth:`prepare_fused`, made here when absent."""
        l1, l2 = self.head[0], self.head[2]
        if (feat_proj is not None and feat_proj.shape[0] != pose_feat.shape[0]
                and t_feat.shape[0] == 1 and self.runs_k1):
            S = pose_feat.shape[0] // feat_proj.shape[0]
            fused = fused if fused is not None else self.prepare_fused(feat_proj)
            p, add = self.fused_inputs(t_feat, pose_feat, fused)
            out = bank_mlp_prepared(p, fused.weights, add, S)
            return out.reshape(out.shape[0], self.num * self.out_dim)
        t_feat, pose_feat, w_t, w_p, b1 = self._cast(
            t_feat, pose_feat, l1.weight[:, :T_DIM], l1.weight[:, T_DIM:TP_DIM], l1.bias)
        h = (torch.einsum("bc,ncd->bnd", t_feat, w_t)
             + torch.einsum("bc,ncd->bnd", pose_feat, w_p) + b1)
        if feat_proj is None:
            h = h + self.precompute_feat(feat)
        elif feat_proj.shape[0] != h.shape[0]:
            B = feat_proj.shape[0]
            h = (h.reshape(B, -1, *h.shape[1:]) + feat_proj[:, None].to(h.dtype)).reshape(h.shape)
        else:
            h = h + feat_proj.to(h.dtype)
        w2, b2 = self._cast(l2.weight, l2.bias)
        out = torch.einsum("bnc,ncd->bnd", torch.relu(h), w2) + b2
        return out.reshape(out.shape[0], self.num * self.out_dim)


class GaussianFourierProjection(nn.Module):
    """Frozen random Fourier features of the diffusion time (buffer ``W``)."""

    def __init__(self, embed_dim: int = 128, scale: float = 30.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", torch.zeros(embed_dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x_proj = t[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Denoiser(nn.Module):
    """Score network for the 'mano_pose' (96-d) or 'obj' (9-d) head."""

    def __init__(self, head: str = "mano_pose", compute_dtype=None):
        super().__init__()
        self.t_encoder = nn.Sequential(GaussianFourierProjection(T_DIM), nn.Linear(T_DIM, T_DIM))
        self.pose_encoder = nn.Sequential(nn.Linear(HEAD_OUT_DIM[head], POSE_DIM), nn.ReLU(),
                                          nn.Linear(POSE_DIM, POSE_DIM), nn.ReLU())
        self.head = BankMLPHead(num=HEAD_BANKS[head], out_dim=3, compute_dtype=compute_dtype)

    def tp_feat(self, sampled_pose: torch.Tensor, t: torch.Tensor):
        """t (Bt, 1) with Bt in {1, B}: the ODE loop passes the shared step time as (1, 1)."""
        return torch.relu(self.t_encoder(t[:, 0])), self.pose_encoder(sampled_pose)

    def precompute_feat(self, feat: torch.Tensor) -> torch.Tensor:
        return self.head.precompute_feat(feat)

    def forward(self, feat, sampled_pose, t, std):
        """Full path: feat (B, 1024); sampled_pose (B, D); t / std (B, 1)."""
        t_feat, p = self.tp_feat(sampled_pose, t)
        return self.head(t_feat, p, feat=feat).float() / (std + 1e-7)

    def score_from_proj(self, feat_proj, sampled_pose, t, std, fused=None):
        """ODE fast path with the precomputed conditioning projection (and, for K1, the
        operands of ``head.prepare_fused``)."""
        t_feat, p = self.tp_feat(sampled_pose, t)
        return self.head(t_feat, p, feat_proj=feat_proj, fused=fused).float() / (std + 1e-7)
