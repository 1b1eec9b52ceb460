"""Hand kinematics tables (counterpart of ``vpho_tpu/utils/hand.py``).

  * ``MANO_PARAMS_LEVEL``: which of the 48 pose parameters belong to kinematic level 0..3
    (wrist / metacarpal / proximal / distal)
  * ``MANO_JOINT_LEVEL``: which of the 21 joints (manopth order) sit at level 0..4
  * ``SKELETON_LEVEL``: bone (parent, child) pairs per level in the 21-joint order

``build_vert2joint`` rebuilds the (21, 778) vertex-to-joint regressor from a MANO model: the
16 MANO regressor rows plus one-hot fingertip rows, in manopth order.
``get_joint_aligned_with_ho3d`` puts joints in HO3D's convention (manolayer order, the
fingertips replaced by mesh vertices).
"""
from __future__ import annotations

import numpy as np
import torch

from .platform import device_index

MANOLAYER_TO_MANOPTH = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20], np.int32
)
MANOPTH_TO_MANOLAYER = np.argsort(MANOLAYER_TO_MANOPTH)

# HO3D's fingertip joints and the mesh vertices that stand in for them
HO3D_TIPS_ID = (16, 17, 18, 19, 20)
HO3D_TIPS_VERT_ID = (728, 353, 442, 576, 694)

MANO_PARAMS_LEVEL = {
    0: [0, 1, 2],
    1: [39, 40, 41] + [3, 4, 5] + [12, 13, 14] + [30, 31, 32] + [21, 22, 23],
    2: [42, 43, 44] + [6, 7, 8] + [15, 16, 17] + [33, 34, 35] + [24, 25, 26],
    3: [45, 46, 47] + [9, 10, 11] + [18, 19, 20] + [36, 37, 38] + [27, 28, 29],
}

MANO_JOINT_LEVEL = {
    0: [0],
    1: [1, 5, 9, 13, 17],
    2: [2, 6, 10, 14, 18],
    3: [3, 7, 11, 15, 19],
    4: [4, 8, 12, 16, 20],
}

SKELETON_LEVEL = {
    0: np.array([[0, 1], [0, 5], [0, 9], [0, 13], [0, 17]]),
    1: np.array([[1, 2], [5, 6], [9, 10], [13, 14], [17, 18]]),
    2: np.array([[2, 3], [6, 7], [10, 11], [14, 15], [18, 19]]),
    3: np.array([[3, 4], [7, 8], [11, 12], [15, 16], [19, 20]]),
}

# tip vertex ids of the vert2joint regressor (index tip 320, unlike the FK's 317)
V2J_TIP_IDS = (745, 320, 444, 556, 673)


def build_vert2joint(j_regressor: np.ndarray) -> np.ndarray:
    """(16, 778) MANO joint regressor -> (21, 778) float32 regressor in manopth order."""
    J = np.asarray(j_regressor)
    tips = np.zeros((5, J.shape[1]), J.dtype)
    tips[np.arange(5), list(V2J_TIP_IDS)] = 1.0
    v2j = np.concatenate([J, tips], axis=0)[MANOLAYER_TO_MANOPTH]
    return v2j.astype(np.float32)


def joint_reorder(joint: torch.Tensor, dst_order: str) -> torch.Tensor:
    """(..., 21, 3) joints into ``manopth`` or ``manolayer`` order."""
    if dst_order == "manopth":
        return joint[..., device_index(MANOLAYER_TO_MANOPTH, joint.device), :]
    if dst_order == "manolayer":
        return joint[..., device_index(MANOPTH_TO_MANOLAYER, joint.device), :]
    raise ValueError(dst_order)


def get_joint_aligned_with_ho3d(vert: torch.Tensor, joint: torch.Tensor) -> torch.Tensor:
    """Manolayer-order joints with the fingertips replaced by their mesh vertices."""
    j = joint_reorder(joint, "manolayer")
    tips = vert[..., device_index(HO3D_TIPS_VERT_ID, vert.device), :]
    return torch.cat([j[..., :HO3D_TIPS_ID[0], :], tips], dim=-2)
