"""Rotation, projection and flip primitives on torch tensors (counterpart of
``vpho_tpu/utils/transforms.py``).

Conventions match the JAX package:
  * quaternions are real-first ``(w, x, y, z)``
  * rot6d is the first two ROWS of the rotation matrix, decoded by Gram-Schmidt
  * projection is ``uv = (K @ xyz)[:2] / z``
"""
from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small inner dimensions as a broadcast product and sum, so it stays plain
    float32 on every device whatever the process's TF32 flags are."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


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


# The dominant-eigenvector solve inside ``average_quaternion``: "eigh" (``torch.linalg.eigh``,
# which checks its status on the host on CUDA) or "power" (repeated squaring: batched 4x4
# matmuls and reductions only).  One choice per process, as in the JAX package
# (``--quat_mean_impl``); set it with ``set_quat_mean_impl``.
QUAT_MEAN_IMPL = "eigh"


def set_quat_mean_impl(impl: str) -> None:
    global QUAT_MEAN_IMPL
    if impl not in ("eigh", "power"):
        raise ValueError(f"quat_mean_impl must be eigh|power, got {impl!r}")
    QUAT_MEAN_IMPL = impl


def dominant_eigvec_4x4_power(A: torch.Tensor, squarings: int = 5) -> torch.Tensor:
    """Dominant eigenvector of PSD (..., 4, 4) matrices by repeated squaring: A^(2^k)
    collapses every column onto the dominant eigenvector, and the largest-norm column is a
    safe representative.  Each squaring renormalizes by the max |entry|."""
    P = A
    for _ in range(squarings):
        P = P / (P.abs().amax(dim=(-2, -1), keepdim=True) + 1e-30)
        P = matmul_f32(P, P)
    best = (P * P).sum(-2).argmax(-1)                        # largest squared column norm
    v = torch.gather(P, -1, best[..., None, None].expand(P.shape[:-1] + (1,)))[..., 0]
    return normalize(v)


def average_quaternion(Q: torch.Tensor, W: torch.Tensor | None = None,
                       impl: str | None = None) -> torch.Tensor:
    """Weighted quaternion mean over the -2 axis: the dominant eigenvector of the weighted
    outer-product sum, returned with a non-negative real part.

    Q: (..., N, 4) real-first; W: (..., N) or None.  ``impl`` overrides ``QUAT_MEAN_IMPL``.
    """
    if W is None:
        W = torch.ones_like(Q[..., 0])
    weight_sum = W.sum(-1, keepdim=True)
    oriented = torch.where(Q[..., :1] > 0, 1.0, -1.0) * Q
    A = (oriented[..., :, None] * oriented[..., None, :] * W[..., None, None]).sum(-3)
    A = A / weight_sum[..., None]
    if (impl or QUAT_MEAN_IMPL) == "power":
        q_avg = dominant_eigvec_4x4_power(A)
    else:
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


def project_pt3d_to_pt2d(pt3d: torch.Tensor, cam_intrinsic: torch.Tensor) -> torch.Tensor:
    """pt3d (..., 3); cam_intrinsic (..., 3, 3) -> (..., 2)."""
    pt2d = matmul_f32(pt3d, cam_intrinsic.transpose(-1, -2))
    return pt2d[..., :-1] / pt2d[..., -1:]


def inverse_project_uvd_to_xyz(uvd: torch.Tensor, cam_intrinsic: torch.Tensor) -> torch.Tensor:
    """uvd (..., 3); cam_intrinsic (..., 3, 3) -> xyz (..., 3)."""
    homog = torch.cat([uvd[..., :-1], torch.ones_like(uvd[..., -1:])], dim=-1)
    return matmul_f32(homog, torch.linalg.inv(cam_intrinsic).transpose(-1, -2)) * uvd[..., -1:]


def rigid_align(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Procrustes-align point sets A (..., N, 3) onto B (..., N, 3) with scale (Umeyama).
    The SVD's singular-vector signs are the library's own; the aligned points are not."""
    n = A.shape[-2]
    centroid_A = A.mean(-2, keepdim=True)
    centroid_B = B.mean(-2, keepdim=True)
    H = matmul_f32((A - centroid_A).transpose(-1, -2), B - centroid_B) / n
    U, s, Vt = torch.linalg.svd(H)
    flip = torch.where(torch.linalg.det(matmul_f32(Vt.transpose(-1, -2), U.transpose(-1, -2)))
                       < 0, -1.0, 1.0)
    s = torch.cat([s[..., :2], s[..., 2:] * flip[..., None]], dim=-1)
    Vt = torch.cat([Vt[..., :2, :], Vt[..., 2:, :] * flip[..., None, None]], dim=-2)
    R = matmul_f32(Vt.transpose(-1, -2), U.transpose(-1, -2))
    varP = A.var(-2, unbiased=False).sum(-1)
    c = s.sum(-1) / varP
    t = centroid_B - c[..., None, None] * matmul_f32(centroid_A, R.transpose(-1, -2))
    return c[..., None, None] * matmul_f32(A, R.transpose(-1, -2)) + t


def obj_9d_to_mat(obj_9d: torch.Tensor) -> torch.Tensor:
    """(..., 9) rot6d + translation -> (..., 3, 4)."""
    return torch.cat([rotation_6d_to_matrix(obj_9d[..., :6]), obj_9d[..., 6:9, None]], dim=-1)


def obj_mat_to_9d(obj_rt: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_rotation_6d(obj_rt[..., :3, :3]), obj_rt[..., :3, 3]], dim=-1)


def matmul_for_rt(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) rigid transforms: T1 after T2."""
    r1, t1 = T1[..., :3, :3], T1[..., :3, 3]
    r2, t2 = T2[..., :3, :3], T2[..., :3, 3]
    new_t = matmul_f32(r1, t2[..., None])[..., 0] + t1
    return torch.cat([matmul_f32(r1, r2), new_t[..., None]], dim=-1)


def mano_aa_to_6d(mano_params: torch.Tensor) -> torch.Tensor:
    """(..., 48 + extra) -> (..., 96 + extra): 16 joints axis-angle -> rot6d."""
    s = mano_params.shape[:-1]
    aa = mano_params[..., :48].reshape(s + (16, 3))
    d6 = matrix_to_rotation_6d(axis_angle_to_matrix(aa)).reshape(s + (96,))
    return torch.cat([d6, mano_params[..., 48:]], dim=-1)


def mano_6d_to_aa(mano_6d: torch.Tensor) -> torch.Tensor:
    """(..., 96 + extra) -> (..., 48 + extra)."""
    s = mano_6d.shape[:-1]
    d6 = mano_6d[..., :96].reshape(s + (16, 6))
    aa = matrix_to_axis_angle(rotation_6d_to_matrix(d6)).reshape(s + (48,))
    return torch.cat([aa, mano_6d[..., 96:]], dim=-1)


def flip_point3d(pt3d: torch.Tensor, is_flip: torch.Tensor) -> torch.Tensor:
    """Negate x for flagged batch elements.  pt3d (B, ..., 3); is_flip (B,) bool."""
    flag = is_flip.reshape((pt3d.shape[0],) + (1,) * (pt3d.dim() - 1))
    sign = torch.where(flag, -1.0, 1.0).to(pt3d.dtype)
    mask = torch.cat([sign.expand(pt3d.shape[:-1] + (1,)),
                      torch.ones_like(pt3d[..., 1:])], dim=-1)
    return pt3d * mask
