"""The hand head's bank-MLP in its plain form (the port's K1, ``ops/bank_mlp.py``):

    out[r, k, :] = bf16(relu(p[r] @ W1[k] + add[b(r), k])) @ W2[k] + b2[k]      (f32 sums)

with bf16-rounded operands and f32 einsums.  ``prepare`` keeps the operands in their plain
layouts; the arithmetic is the kernel's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..precision import to_compute


class BankWeights(NamedTuple):
    """The constant operands, plain layouts: w1 (n, C, D), w2 (n, D, O) bf16, b2 (n, O) f32."""

    w1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def prepare(w1_pose: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> BankWeights:
    bf = torch.bfloat16
    return BankWeights(to_compute(w1_pose, bf), to_compute(w2, bf), b2.float())


def bank_mlp_plain(pose_feat: torch.Tensor, w1_pose: torch.Tensor, add: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, S: int) -> torch.Tensor:
    """bf16-rounded operands, f32 einsums, h rounded to bf16 after the relu."""
    bf = torch.bfloat16
    B, n, D = add.shape
    p = to_compute(pose_feat, bf).float()
    w1 = to_compute(w1_pose, bf).float()
    h = torch.einsum("rc,ncd->rnd", p, w1).reshape(B, S, n, D) + add.float()[:, None]
    h = to_compute(torch.relu(h), bf).float().reshape(B * S, n, D)
    out = torch.einsum("rnd,ndo->rno", h, to_compute(w2, bf).float())
    return out + b2.float()


def bank_mlp_prepared(pose_feat: torch.Tensor, w: BankWeights, add: torch.Tensor,
                      S: int) -> torch.Tensor:
    """pose_feat (B*S, C); add (B, n, D) f32 -> (B*S, n, O) f32."""
    return bank_mlp_plain(pose_feat, w.w1, add, w.w2, w.b2, S)
