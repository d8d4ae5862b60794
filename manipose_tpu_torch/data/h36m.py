"""Human3.6M lifting dataset (host-side).

Rebuild of ``hpe/mh_so3_hpe/data/h36m_lifting.py:586-688`` +
``mocap_dataset.py`` + ``data/utils.py``: loads the ``data_3d_h36m.npz``
mocap archive, reduces the skeleton to 17 (or 16) joints, attaches the
camera rig, converts world -> per-camera root-relative 3D, and
screen-normalizes 2D detections.

The port's own copy of ``manipose_tpu/data/h36m.py`` (host-side numpy, on
the port's ``geometry`` and ``data.h36m_cameras``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..geometry import h36m_skeleton_16, h36m_skeleton_17
from ..geometry.h36m import H36M_NAMES_32, REMOVED_JOINTS_17
from ..geometry.skeleton import Skeleton
from .cameras import normalize_screen_coordinates, world_to_camera
from .h36m_cameras import build_cameras

ALL_ACTIONS = (
    "directions", "discussion", "eating", "greeting", "phoning", "photo",
    "posing", "purchases", "sitting", "sittingdown", "smoking", "waiting",
    "walkdog", "walking", "walktogether",
)


class Human36mDataset:
    """3D mocap + camera container (``h36m_lifting.py:586-661``)."""

    def __init__(self, path, n_joints: int = 17):
        assert n_joints in (16, 17)
        self.fps = 50
        self._cameras = build_cameras()
        if n_joints == 17:
            self._skeleton = h36m_skeleton_17()
            kept = [j for j in range(32) if j not in REMOVED_JOINTS_17]
        else:
            self._skeleton = h36m_skeleton_16()
            kept = [
                j for j, n in enumerate(H36M_NAMES_32)
                if n not in ("", "Neck/Nose")
            ]
        self._kept_joints = np.asarray(kept)

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        self._data: Dict[str, Dict[str, dict]] = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    "positions": positions[:, self._kept_joints],
                    "cameras": self._cameras[subject],
                }

    def __getitem__(self, subject: str):
        return self._data[subject]

    @property
    def subjects(self):
        return self._data.keys()

    @property
    def skeleton(self) -> Skeleton:
        return self._skeleton

    @property
    def cameras(self):
        return self._cameras

    @staticmethod
    def define_actions(action: Optional[str] = None) -> List[str]:
        """(``h36m_lifting.py:663-688``)"""
        if action is None:
            return list(ALL_ACTIONS)
        if action not in ALL_ACTIONS:
            raise ValueError(f"Undefined action: {action}")
        return [action]


def read_3d_data(
    dataset: Human36mDataset,
    subjects_filter: Optional[Sequence[str]] = None,
    action_filter: Optional[Sequence[str]] = None,
) -> Human36mDataset:
    """World -> per-camera root-relative 3D (``data/utils.py:29-58``)."""
    for subject in dataset.subjects:
        if subjects_filter is not None and subject not in subjects_filter:
            continue
        for action, anim in dataset[subject].items():
            if action_filter is not None and action not in action_filter:
                continue
            positions_3d = []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"],
                    R=cam["orientation"],
                    t=cam["translation"],
                )
                pos_3d -= pos_3d[:, :1]  # root-relative
                positions_3d.append(pos_3d.astype(np.float32))
            anim["positions_3d"] = positions_3d
    return dataset


def create_2d_data(data_path, dataset: Human36mDataset) -> dict:
    """Load 2D keypoints npz and screen-normalize per camera
    (``data/utils.py:9-26``)."""
    keypoints = np.load(data_path, allow_pickle=True)["positions_2d"].item()
    for subject in keypoints:
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras[subject][cam_idx]
                kps[..., :2] = normalize_screen_coordinates(
                    kps[..., :2], w=cam["res_w"], h=cam["res_h"]
                )
                keypoints[subject][action][cam_idx] = kps
    return keypoints


def fetch(
    subjects: Sequence[str],
    dataset: Human36mDataset,
    keypoints: dict,
    action_filter: Optional[Sequence[str]] = None,
    stride: int = 1,
    parse_3d_poses: bool = True,
) -> Tuple[Optional[list], list, list, list]:
    """Flatten (subject, action, camera) -> lists of per-video arrays
    (``data/utils.py:61-128``); camera vectors are the 16-dim augmented
    form (intrinsic 9 + orientation 4 + translation 3) plus cam index."""
    out_poses_3d, out_poses_2d, out_actions, out_cams = [], [], [], []
    for subject in subjects:
        for action in keypoints[subject].keys():
            if action_filter is not None:
                base = action.lower().split(" ")[0]
                if base not in action_filter:
                    continue
            cams = dataset.cameras[subject]
            poses_2d = keypoints[subject][action]
            for i in range(len(poses_2d)):
                out_poses_2d.append(poses_2d[i])
                out_actions.append([action.split(" ")[0]] * poses_2d[i].shape[0])
                augmented_cam = np.concatenate(
                    [
                        cams[i]["intrinsic"],
                        cams[i]["orientation"],
                        cams[i]["translation"],
                        np.array([i], dtype=np.float32),
                    ]
                )
                out_cams.append([augmented_cam] * poses_2d[i].shape[0])
            if parse_3d_poses and "positions_3d" in dataset[subject][action]:
                poses_3d = dataset[subject][action]["positions_3d"]
                assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
                out_poses_3d.extend(poses_3d)

    if len(out_poses_3d) == 0:
        out_poses_3d = None
    if stride > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::stride]
            out_actions[i] = out_actions[i][::stride]
            out_cams[i] = out_cams[i][::stride]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][::stride]
    return out_poses_3d, out_poses_2d, out_actions, out_cams
