"""Synthetic-but-learnable pose videos from the port's forward kinematics.

The port's copy of the data half of ``tools/synthetic_overfit.py``
(``make_videos`` and ``BONE_LENGTHS``): smooth random 6D rotation
trajectories decoded by ``rot6d_to_matrix`` and ``forward_kinematics`` in
fp32 on the CPU, with fixed bone lengths, and a pinhole 2D projection. The
numpy draws are the JAX tool's, call for call, so one seed gives the same
trajectories; the FK agrees with the JAX package's to float32 rounding
(about 1e-6 m). The tool's training half is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import forward_kinematics, rot6d_to_matrix
from ..geometry.skeleton import Skeleton

# realistic-ish H36M-17 bone lengths (meters)
BONE_LENGTHS = np.asarray(
    [0.13, 0.45, 0.45, 0.13, 0.45, 0.45, 0.25, 0.25, 0.12, 0.12,
     0.15, 0.28, 0.25, 0.15, 0.28, 0.25], np.float32
)


def make_videos(n_videos: int, n_frames: int, skel: Skeleton, seed: int = 0):
    """Smooth random rotation trajectories -> FK -> pinhole 2D. Returns
    (list of (n_frames, J, 3) root-relative poses in meters, list of
    (n_frames, J, 2) projections with the camera at z = 4 m)."""
    rng = np.random.default_rng(seed)
    videos_3d, videos_2d = [], []
    for _ in range(n_videos):
        # smooth 6D rotation trajectories: random walk, low-pass filtered
        rep = rng.normal(size=(n_frames + 40, skel.num_joints, 6)).astype(
            np.float32
        )
        kernel = np.hamming(41)
        kernel /= kernel.sum()
        rep = np.apply_along_axis(
            lambda s: np.convolve(s, kernel, mode="valid"), 0, rep
        )[:n_frames]
        # moderate deviations around the T-pose: learnable structure
        rep = rep * 1.2 + np.asarray([1, 0, 0, 0, 1, 0], np.float32)
        with torch.no_grad():
            rot = rot6d_to_matrix(torch.as_tensor(rep, dtype=torch.float32))
            pose = forward_kinematics(
                rot, torch.from_numpy(BONE_LENGTHS),
                torch.zeros((n_frames, 3)), skel,
            ).numpy()
        # camera at z = 4m: root-relative 3D target, pinhole 2D input
        depth = pose[..., 2] + 4.0
        p2 = pose[..., :2] / depth[..., None]
        videos_3d.append(pose.astype(np.float32))
        videos_2d.append(p2.astype(np.float32))
    return videos_3d, videos_2d
