"""The eval loop's post-processing of a prediction (copies of the port's
``engine/trainer.py::postprocess_obj_rt`` and ``postprocess_hand_vert``)."""
from __future__ import annotations

import torch

from ..utils import transforms as T


def postprocess_obj_rt(pose9d: torch.Tensor, root_joint: torch.Tensor) -> torch.Tensor:
    """Wrist-relative (B, ..., 9) pose -> camera-frame (B, ..., 3, 4) rt."""
    rt = T.obj_9d_to_mat(pose9d)
    root = root_joint.reshape((root_joint.shape[0],) + (1,) * (rt.dim() - 3) + (3,))
    return torch.cat([rt[..., :3], rt[..., 3:] + root[..., None]], dim=-1)


def postprocess_hand_vert(vert: torch.Tensor, root_joint: torch.Tensor,
                          is_right: torch.Tensor) -> torch.Tensor:
    """Unflip left hands and move from wrist-relative to the camera frame."""
    vert = T.flip_point3d(vert, ~is_right)
    return vert + root_joint.reshape((root_joint.shape[0],) + (1,) * (vert.dim() - 2) + (3,))
