"""The nearest-vertex search in its plain form (the port's K2, ``ops/min_dist.py``):

    d2 = (|x|^2 + |y|^2) - 2 x.y,   dist = sqrt(max(min_v d2, 0)),   idx = first argmin
"""
from __future__ import annotations

import torch


def min_dist_and_idx(fp: torch.Tensor, verts: torch.Tensor):
    """fp (B, N, P, 3); verts (B, V, 3) -> dist (B, N, P) f32, idx (B, N, P) int32; the
    (B, N, P, V) squared distances are materialized."""
    fp, verts = fp.float(), verts.float()
    x2 = (fp * fp).sum(-1)
    y2 = (verts * verts).sum(-1)
    xy = torch.einsum("bnkd,bvd->bnkv", fp, verts)
    d2 = x2[..., None] + y2[:, None, None] - 2.0 * xy
    dist = torch.sqrt(torch.clamp_min(d2.min(-1).values, 0.0))
    return dist, torch.argmin(d2, dim=-1).to(torch.int32)
