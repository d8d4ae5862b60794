"""MPI-INF-3DHP dataset (host-side).

The port's own copy of ``manipose_tpu/data/dhp3.py`` (numpy only). Rebuild
of ``hpe/mh_so3_hpe/data/dataset_3dhp.py:103-221``: loads the
data_train_3dhp.npz / data_test_3dhp.npz archives, permutes joints into
H36M order, root-centers at the hip (MPI joint 14), converts mm -> m,
drops invalid test frames, and screen-normalizes 2D (TS5/TS6 are
1920x1080, the rest 2048x2048).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..geometry.h36m import _T_POSE_OPERATORS_REDUCED  # same reduced set
from ..geometry.skeleton import Skeleton
from .cameras import normalize_screen_coordinates

# MPI joint indices in H36M joint order (``dataset_3dhp.py:56-74``).
MAP_H36M_TO_MPI_JOINTS = (
    14, 8, 9, 10, 11, 12, 13, 15, 1, 16, 0, 5, 6, 7, 2, 3, 4,
)

JOINT_NAMES = (
    "Hip", "RHip", "RKnee", "RFoot", "LHip", "LKnee", "LFoot", "Spine",
    "Thorax", "Neck/Nose", "Head", "LShoulder", "LElbow", "LWrist",
    "RShoulder", "RElbow", "RWrist",
)

# sensor rasters (width, height): TS5/TS6 are 1920x1080, the rest 2048x2048
# (``dataset_3dhp.py:206-212``)
FULL_HD_SEQUENCES = ("TS5", "TS6")


def raster(seq: str) -> Tuple[int, int]:
    """The (width, height) in pixels of test sequence ``seq``'s camera."""
    return (1920, 1080) if seq in FULL_HD_SEQUENCES else (2048, 2048)


def dhp3_skeleton() -> Skeleton:
    """17-joint skeleton in H36M order (``dataset_3dhp.py:132-138``), the
    topology of the H36M-17 working skeleton."""
    return Skeleton(
        parents=(-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15),
        joints_left=(4, 5, 6, 11, 12, 13),
        joints_right=(1, 2, 3, 14, 15, 16),
        joints_names=JOINT_NAMES,
        t_pose_operators=_T_POSE_OPERATORS_REDUCED,
    )


class Dataset3DHP:
    """Train/test pose lists ready for :class:`PoseSequenceDataset`."""

    def __init__(self, root_path, train: bool = True):
        self.train = train
        self.skeleton = dhp3_skeleton()
        self.poses, self.poses_2d = self.prepare_data(Path(root_path), train)

    @staticmethod
    def prepare_data(
        path: Path, train: bool
    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """(``dataset_3dhp.py:146-221``)"""
        perm = list(MAP_H36M_TO_MPI_JOINTS)
        out_3d, out_2d = [], []
        if train:
            data = np.load(
                path / "data_train_3dhp.npz", allow_pickle=True
            )["data"].item()
            for seq in data.keys():
                for cam in data[seq][0].keys():
                    anim = data[seq][0][cam]
                    data_3d = np.array(anim["data_3d"])
                    data_3d -= data_3d[:, 14:15]  # root-center at MPI hip
                    out_3d.append((data_3d[:, perm] / 1000.0).astype(np.float32))
                    data_2d = np.array(anim["data_2d"])
                    data_2d[..., :2] = normalize_screen_coordinates(
                        data_2d[..., :2], w=2048, h=2048
                    )
                    out_2d.append(data_2d[:, perm].astype(np.float32))
        else:
            data = np.load(
                path / "data_test_3dhp.npz", allow_pickle=True
            )["data"].item()
            for seq in data.keys():
                anim = data[seq]
                valid = np.asarray(anim["valid"]).astype(bool)
                data_3d = np.array(anim["data_3d"])
                data_3d -= data_3d[:, 14:15]
                out_3d.append(
                    (data_3d[valid][:, perm] / 1000.0).astype(np.float32)
                )
                data_2d = np.array(anim["data_2d"])
                width, height = raster(seq)
                data_2d[..., :2] = normalize_screen_coordinates(
                    data_2d[..., :2], w=width, h=height
                )
                out_2d.append(data_2d[valid][:, perm].astype(np.float32))
        return out_3d, out_2d
