"""Sequence windowing, occlusion simulation and flip augmentation.

Rebuild of ``hpe/mh_so3_hpe/data/generators.py:44-222`` (the torch
``PoseSequenceGenerator``) as a host-side numpy dataset feeding fixed
static shapes to the device. Windows are L-frame clips per video: random
start at train time, sequential non-overlapping at eval; the replicate-pad
path covers the last short window when ``drop_last=False``. The five
keypoint "miss" patterns reproduce the reference's robustness feature.

All randomness flows through an explicit ``np.random.Generator`` (the
reference relies on global torch/np seeding, ``utils.py:117-120``).

The port's own copy of ``manipose_tpu/data/windowing.py``: it draws from
the generator call for call as the JAX package does, so one seed gives
the same batches bit for bit; ``get_batch`` gathers windows with the
port's binding of the native core.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ..geometry.skeleton import Skeleton

# Sampling rates for miss_type="all" (``generators.py:49-56``).
POSSIBLE_MISS_TYPES_RATES = {
    "no_miss": 0.2,
    "random": 0.2,
    "random_left_arm_right_leg": 0.4,
    "structured_joint": 0.4,
    "structured_frame": 0.2,
}

# Joint groups used by the structured patterns (H36M-17 indices,
# ``generators.py:187,197``).
LEFT_ARM_RIGHT_LEG = (1, 2, 3, 11, 12, 13)
RIGHT_LEG = (1, 2, 3)


def pose_flip(
    poses: Sequence[np.ndarray], skeleton: Skeleton
) -> Tuple[np.ndarray, ...]:
    """Horizontal flip: negate x/u and swap left<->right joints.

    Functional (returns copies) — the reference mutates its inputs in
    place (``augmentations/functional.py:7-28``), which this build treats
    as a bug rather than behavior to preserve.
    """
    out = []
    left = list(skeleton.joints_left)
    right = list(skeleton.joints_right)
    for pose in poses:
        if pose.shape[-1] not in (2, 3) or pose.shape[-2] != skeleton.num_joints:
            raise ValueError(f"pose of shape {pose.shape} is not (..., "
                             f"{skeleton.num_joints}, 2 or 3)")
        flipped = np.array(pose)
        flipped[..., 0] *= -1
        flipped[..., left + right, :] = flipped[..., right + left, :]
        out.append(flipped)
    return tuple(out)


def make_miss_mask(
    rng: np.random.Generator,
    seq_len: int,
    num_joints: int,
    miss_type: str,
    miss_rate: float,
) -> np.ndarray:
    """(L, J) multiplicative keypoint mask (``generators.py:162-214``)."""
    shape = (seq_len, num_joints)
    if miss_type == "no_miss":
        return np.ones(shape, np.float32)
    if miss_type == "random":
        u = rng.uniform(0.0, 1.0, size=shape)
        return (u > miss_rate).astype(np.float32)
    if miss_type == "random_left_arm_right_leg":
        mask = np.ones(shape, np.float32)
        rand = rng.choice(
            seq_len, size=math.floor(miss_rate * seq_len), replace=False
        )
        for j in LEFT_ARM_RIGHT_LEG:
            mask[rand, j] = 0.0
        return mask
    if miss_type == "structured_joint":
        mask = np.ones(shape, np.float32)
        occl_len = int(seq_len * miss_rate)
        start = int(rng.choice(seq_len - occl_len))
        mask[start : start + occl_len, list(RIGHT_LEG)] = 0.0
        return mask
    if miss_type == "structured_frame":
        mask = np.ones(shape, np.float32)
        occl_len = int(seq_len * miss_rate)
        start = int(rng.choice(seq_len - occl_len))
        mask[start : start + occl_len] = 0.0
        return mask
    raise ValueError(f"Unexpected miss_type: {miss_type}")


class PoseSequenceDataset:
    """Windowed (2D, 3D) pose-sequence sampler.

    Args mirror ``PoseSequenceGenerator.__init__``
    (``generators.py:58-104``); ``flip_probability > 0`` enables the
    train-time flip transform (the reference wires ``PoseFlip(p=0.5)``
    via ``main_h36m_lifting.py:584-585``).
    """

    def __init__(
        self,
        poses_3d: Sequence[np.ndarray],
        poses_2d: Sequence[np.ndarray],
        cameras: Optional[Sequence[np.ndarray]] = None,
        seq_len: int = 243,
        random_start: bool = False,
        drop_last: bool = True,
        miss_type: str = "no_miss",
        miss_rate: float = 0.2,
        noise_sigma: float = 5.0,
        skeleton: Optional[Skeleton] = None,
        flip_probability: float = 0.0,
    ):
        if poses_3d is None or len(poses_3d) != len(poses_2d):
            raise ValueError("one 3D pose sequence per 2D sequence is needed")
        if flip_probability > 0 and skeleton is None:
            raise ValueError("flip augmentation needs a skeleton")
        self.seq_len = seq_len
        self.random_start = random_start
        self.drop_last = drop_last
        self.miss_type = miss_type
        self.miss_rate = miss_rate
        self.noise_sigma = noise_sigma
        self.skeleton = skeleton
        self.flip_probability = flip_probability
        self._poses_3d = [np.asarray(p, np.float32) for p in poses_3d]
        self._poses_2d = [np.asarray(p, np.float32) for p in poses_2d]
        self._cameras = cameras

        # index -> (video, start-frame) tables (``generators.py:87-104``)
        map_pose, map_frame = [], []
        for i, pose in enumerate(self._poses_3d):
            pose_size = pose.shape[0] // seq_len
            if not drop_last and pose.shape[0] % seq_len > 0:
                pose_size += 1
            map_pose += [i] * pose_size
            map_frame += [k * seq_len for k in range(pose_size)]
        self._map_index_to_pose = np.asarray(map_pose, np.int64)
        self._map_index_to_frame = np.asarray(map_frame, np.int64)

    def __len__(self) -> int:
        return len(self._map_index_to_pose)

    @property
    def num_joints(self) -> int:
        return self._poses_3d[0].shape[1]

    def get_batch(
        self, indices: np.ndarray, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (pose_2d (B, L, J, 2) with miss masks applied, pose_3d
        (B, L, J, 3)) for the windows ``indices``: random or sequential
        starts, replicate padding of the last short window, flip and miss
        masks. All clips are gathered in one multithreaded pass of the
        native core and the masks applied in bulk; the draws from ``rng``
        are the JAX package's ``get_batch``'s, call for call. The only
        windowing path: a single window is ``get_batch([i], rng)``.
        """
        from . import native

        if rng is None:
            rng = np.random.default_rng()
        indices = np.asarray(indices)
        video_idx = self._map_index_to_pose[indices]
        if self.random_start:
            highs = np.asarray(
                [self._poses_3d[v].shape[0] - self.seq_len for v in video_idx]
            )
            # exact-length videos (high == 0) have one valid start: 0
            starts = np.where(
                highs > 0, rng.integers(0, np.maximum(highs, 1)), 0
            )
        else:
            starts = self._map_index_to_frame[indices]

        clips_2d = native.gather_windows(
            self._poses_2d, video_idx, starts, self.seq_len
        )
        clips_3d = native.gather_windows(
            self._poses_3d, video_idx, starts, self.seq_len
        )

        if self.flip_probability > 0:
            flip = rng.uniform(size=len(indices)) <= self.flip_probability
            if flip.any():
                f2, f3 = pose_flip(
                    (clips_2d[flip], clips_3d[flip]), self.skeleton
                )
                clips_2d[flip] = f2
                clips_3d[flip] = f3

        n_joints = clips_2d.shape[2]
        if self.miss_type == "noisy":
            clips_2d = clips_2d + rng.normal(
                0.0, self.noise_sigma, size=clips_2d.shape
            ).astype(np.float32)
        elif self.miss_type != "no_miss":
            masks = np.empty((len(indices), self.seq_len, n_joints), np.float32)
            for i in range(len(indices)):
                miss_type, miss_rate = self.miss_type, self.miss_rate
                if miss_type == "all":
                    miss_type = str(rng.choice(list(POSSIBLE_MISS_TYPES_RATES)))
                    miss_rate = POSSIBLE_MISS_TYPES_RATES[miss_type]
                if miss_type == "noisy":
                    masks[i] = 1.0
                    clips_2d[i] += rng.normal(
                        0.0, self.noise_sigma, size=clips_2d[i].shape
                    ).astype(np.float32)
                else:
                    masks[i] = make_miss_mask(
                        rng, self.seq_len, n_joints, miss_type, miss_rate
                    )
            clips_2d = native.apply_masks(
                np.ascontiguousarray(clips_2d), masks
            )
        return clips_2d, clips_3d
