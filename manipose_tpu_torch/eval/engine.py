"""Evaluation helpers of the port (the serving slice needs the TTA flip).

Port of ``manipose_tpu/eval/engine.py::flip_poses``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.skeleton import Skeleton


def flip_poses(poses: torch.Tensor, skeleton: Skeleton) -> torch.Tensor:
    """Horizontal flip: negate u/x, swap left and right joints."""
    perm = np.arange(skeleton.num_joints)
    left = np.asarray(skeleton.joints_left)
    right = np.asarray(skeleton.joints_right)
    perm[left] = right
    perm[right] = left
    sign = torch.ones(poses.shape[-1], dtype=poses.dtype, device=poses.device)
    sign[0] = -1.0
    return poses[..., torch.as_tensor(perm, device=poses.device), :] * sign
