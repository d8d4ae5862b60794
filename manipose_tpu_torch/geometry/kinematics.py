"""Forward kinematics and T-pose construction, level-parallel.

Port of ``manipose_tpu/geometry/kinematics.py``: the tree is processed by
level, so all joints at equal depth share one batched 3x3 product.

- world rotation of joint j = world rotation of parent @ local rotation j
- position j = world_rot_j @ (t_pose_operator_j * bone_length_{j-1})
  + position_parent; the root sits at the given root position.

Each level's results are collected per joint and stacked once at the end,
so no tensor is written in place (the result stays differentiable).

Dtypes follow the JAX package: the T-pose operators are fp32, so bf16 bone
lengths give fp32 offsets, and each bf16 joint position is computed in
fp32 from them and rounded to bf16 where it is stored (the JAX rollout
writes fp32 values into a bf16 buffer); world rotations stay in the
rotations' dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .rotations import compose_rotations, rotate_vectors
from .skeleton import Skeleton


def _check_topological(skeleton: Skeleton) -> None:
    parents = skeleton.parents
    if parents[0] != -1:
        raise ValueError("joint 0 must be the root")
    for j, p in enumerate(parents[1:], start=1):
        if not 0 <= p < j:
            raise ValueError(
                "kinematics requires topologically-ordered parents "
                f"(parents[{j}]={p}); bone b must connect joint b+1 to its "
                "parent"
            )


@functools.lru_cache(maxsize=None)
def _t_pose_on(skeleton: Skeleton, device: torch.device) -> torch.Tensor:
    """The skeleton's (J, 3) T-pose operators on ``device``, copied there
    once: a step makes no host-to-device copy (and can be captured in a
    CUDA graph, where a copy from pageable memory is refused). Made outside
    inference mode, so that autograd may save it whoever asked first."""
    with torch.inference_mode(False):
        return torch.as_tensor(skeleton.t_pose_array(), device=device)


def _offsets(bone_lengths: torch.Tensor, skeleton: Skeleton) -> torch.Tensor:
    """(..., num_bones) -> (..., J, 3): ops[j] * len[j-1], row 0 zero, in
    the lengths' dtype promoted with the fp32 operators."""
    ops = _t_pose_on(skeleton, bone_lengths.device)
    lengths = torch.cat(
        [torch.zeros_like(bone_lengths[..., :1]), bone_lengths], dim=-1
    )
    return lengths[..., None] * ops


def build_t_pose(bone_lengths: torch.Tensor, skeleton: Skeleton) -> torch.Tensor:
    """(..., num_bones) per-bone lengths -> (..., J, 3) T-pose positions
    (root at the origin): position_j = sum over ancestors a of j (j
    included, root excluded) of operator_a * length_{a-1}."""
    _check_topological(skeleton)
    offsets = _offsets(bone_lengths, skeleton)
    ancestry = _ancestry_on(skeleton, offsets.device).to(offsets.dtype)
    return torch.einsum("ja,...ac->...jc", ancestry, offsets)


@functools.lru_cache(maxsize=None)
def _ancestry_on(skeleton: Skeleton, device: torch.device) -> torch.Tensor:
    """(J, J) fp32: [j, a] = 1 where a is j or an ancestor of j below the
    root; on ``device``, copied there once."""
    n_joints = skeleton.num_joints
    ancestry = np.zeros((n_joints, n_joints), dtype=np.float32)
    for j in range(1, n_joints):
        a = j
        while a != 0:
            ancestry[j, a] = 1.0
            a = skeleton.parents[a]
    with torch.inference_mode(False):
        return torch.as_tensor(ancestry, device=device)


def forward_kinematics(
    rotations: torch.Tensor,
    bone_lengths: torch.Tensor,
    root_positions: torch.Tensor,
    skeleton: Skeleton,
) -> torch.Tensor:
    """Level-parallel FK rollout.

    Args:
      rotations: (..., J, 3, 3) local rotation matrices.
      bone_lengths: (..., num_bones), broadcastable to the rotations' batch.
      root_positions: (..., 3), broadcastable likewise.
    Returns:
      (..., J, 3) world joint positions.
    """
    _check_topological(skeleton)
    n_joints = skeleton.num_joints
    if rotations.shape[-3:] != (n_joints, 3, 3):
        raise ValueError(f"rotations must end in ({n_joints}, 3, 3)")
    batch_shape = torch.broadcast_shapes(
        rotations.shape[:-3], bone_lengths.shape[:-1], root_positions.shape[:-1]
    )
    dtype = rotations.dtype
    rotations = rotations.expand(batch_shape + (n_joints, 3, 3))
    bone_lengths = bone_lengths.to(dtype).expand(
        batch_shape + (skeleton.num_bones,)
    )
    root_positions = root_positions.to(dtype).expand(batch_shape + (3,))
    offsets = _offsets(bone_lengths, skeleton)  # (..., J, 3)

    world_rot = [None] * n_joints
    positions = [None] * n_joints
    world_rot[0] = rotations[..., 0, :, :]
    positions[0] = root_positions
    parents = skeleton.parents
    for level in skeleton.levels[1:]:
        js = list(level)
        r_parent = torch.stack([world_rot[parents[j]] for j in js], dim=-3)
        p_parent = torch.stack([positions[parents[j]] for j in js], dim=-2)
        # stacks of views, not list indexing: an index list would be copied
        # to the device at every call, which a CUDA-graph capture refuses
        r_world = compose_rotations(
            r_parent, torch.stack([rotations[..., j, :, :] for j in js], dim=-3))
        off = torch.stack([offsets[..., j, :] for j in js], dim=-2)
        pos = rotate_vectors(r_world.to(off.dtype), off) + p_parent
        for i, j in enumerate(js):
            world_rot[j] = r_world[..., i, :, :]
            positions[j] = pos[..., i, :].to(dtype)
    return torch.stack(positions, dim=-2)
