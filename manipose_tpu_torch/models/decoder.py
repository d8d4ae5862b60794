"""Pose decoder: rotation representation + bone lengths -> 3D joints.

Port of ``manipose_tpu/models/decoder.py::decode_poses``: rotation
conversion and level-parallel FK over arbitrary leading axes, so the rMCL
case (B, H, L, ...) needs no reshapes.
"""

from __future__ import annotations

import torch

from ..geometry import forward_kinematics, rot_to_matrix
from ..geometry.skeleton import Skeleton


def decode_poses(
    rotations_repr: torch.Tensor,  # (..., J, rot_rep_dim)
    bone_lengths: torch.Tensor,  # (..., num_bones) broadcastable
    root_positions: torch.Tensor,  # (..., 3) broadcastable
    skeleton: Skeleton,
    rot_rep_dim: int = 6,
) -> torch.Tensor:
    """-> (..., J, 3) world joint positions on the pose manifold."""
    if rotations_repr.shape[-1] != rot_rep_dim:
        raise ValueError(
            f"rotation representation dim mismatch: "
            f"{rotations_repr.shape[-1]} != {rot_rep_dim}"
        )
    if rotations_repr.shape[-2] != skeleton.num_joints:
        raise ValueError("rotations must have one entry per skeleton joint")
    rotations = rot_to_matrix(rotations_repr, rot_rep_dim)
    return forward_kinematics(rotations, bone_lengths, root_positions, skeleton)
