from .skeleton import Skeleton
from .rotations import (
    compose_rotations,
    normalize_vector,
    rot4d_to_matrix,
    rot6d_to_matrix,
    rot_to_matrix,
    rotate_vectors,
)
from .kinematics import build_t_pose, forward_kinematics
from .h36m import (
    h36m_skeleton_16,
    h36m_skeleton_17,
    h36m_skeleton_32,
)

__all__ = [
    "Skeleton",
    "compose_rotations",
    "normalize_vector",
    "rot4d_to_matrix",
    "rot6d_to_matrix",
    "rot_to_matrix",
    "rotate_vectors",
    "build_t_pose",
    "forward_kinematics",
    "h36m_skeleton_16",
    "h36m_skeleton_17",
    "h36m_skeleton_32",
]
