"""Rotation, projection and flip primitives on torch tensors (counterpart of
``vpho_tpu/utils/transforms.py``).

Conventions match the JAX package:
  * quaternions are real-first ``(w, x, y, z)``
  * rot6d is the first two ROWS of the rotation matrix, decoded by Gram-Schmidt
  * projection is ``uv = (K @ xyz)[:2] / z``
"""
from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero gradient at x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    n = safe_sqrt((v * v).sum(dim=dim, keepdim=True))
    return v / (n + eps)


def _sin_half_over_angle(angle: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(angle/2)/angle with the 1/2 - angle^2/48 series below 1e-6."""
    small = angle.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    return torch.where(small, 0.5 - (angle * angle) / 48.0, torch.sin(half) / safe)


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) real-first quaternion."""
    sq = (aa * aa).sum(-1, keepdim=True)
    angle = torch.sqrt(torch.clamp_min(sq, 1e-24))
    half = angle * 0.5
    return torch.cat([torch.cos(half), aa * _sin_half_over_angle(angle, half)], dim=-1)


def quaternion_to_axis_angle(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) real-first quaternion -> (..., 3) axis-angle."""
    norms = safe_sqrt((quat[..., 1:] ** 2).sum(-1, keepdim=True))
    half_angles = torch.atan2(norms, quat[..., :1])
    angles = 2.0 * half_angles
    return quat[..., 1:] / _sin_half_over_angle(angles, half_angles)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) real-first quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / (quat * quat).sum(-1)
    o = torch.stack([
        1 - two_s * (y * y + z * z), two_s * (x * y - z * w), two_s * (x * z + y * w),
        two_s * (x * y + z * w), 1 - two_s * (x * x + z * z), two_s * (y * z - x * w),
        two_s * (x * z - y * w), two_s * (y * z + x * w), 1 - two_s * (x * x + y * y),
    ], dim=-1)
    return o.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) real-first quaternion: the candidate with the largest
    denominator of the four (pytorch3d algorithm)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = safe_sqrt(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp_min(q_abs[..., None], 0.1))
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(candidates, -2, index)[..., 0, :]


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3); rows are the Gram-Schmidt frame."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = normalize(a1)
    b2 = normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def average_quaternion(Q: torch.Tensor, W: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted quaternion mean over the -2 axis: the dominant eigenvector (eigh) of the
    weighted outer-product sum, returned with a non-negative real part.

    Q: (..., N, 4) real-first; W: (..., N) or None.
    """
    if W is None:
        W = torch.ones_like(Q[..., 0])
    weight_sum = W.sum(-1, keepdim=True)
    oriented = torch.where(Q[..., :1] > 0, 1.0, -1.0) * Q
    A = (oriented[..., :, None] * oriented[..., None, :] * W[..., None, None]).sum(-3)
    A = A / weight_sum[..., None]
    q_avg = torch.linalg.eigh(A)[1][..., -1]
    return torch.where(q_avg[..., :1] > 0, 1.0, -1.0) * q_avg


def average_rot6d(rot6d: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Average rot6d candidates over the -2 axis."""
    if weights is None:
        weights = torch.ones_like(rot6d[..., 0]) / rot6d.shape[-2]
    quat = matrix_to_quaternion(rotation_6d_to_matrix(rot6d))
    mean = average_quaternion(quat, weights)
    return matrix_to_rotation_6d(quaternion_to_matrix(mean))


def project_points_batched(pt3d: torch.Tensor, cam_intrinsic: torch.Tensor) -> torch.Tensor:
    """pt3d (B, ..., 3); cam_intrinsic (B, 3, 3) -> (B, ..., 2)."""
    B = pt3d.shape[0]
    pt2d = torch.bmm(pt3d.reshape(B, -1, 3), cam_intrinsic.transpose(1, 2))
    pt2d = pt2d.reshape(pt3d.shape)
    return pt2d[..., :2] / pt2d[..., 2:]


def flip_point3d(pt3d: torch.Tensor, is_flip: torch.Tensor) -> torch.Tensor:
    """Negate x for flagged batch elements.  pt3d (B, ..., 3); is_flip (B,) bool."""
    flag = is_flip.reshape((pt3d.shape[0],) + (1,) * (pt3d.dim() - 1))
    sign = torch.where(flag, -1.0, 1.0).to(pt3d.dtype)
    mask = torch.cat([sign.expand(pt3d.shape[:-1] + (1,)),
                      torch.ones_like(pt3d[..., 1:])], dim=-1)
    return pt3d * mask
