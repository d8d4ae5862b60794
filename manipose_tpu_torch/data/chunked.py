"""Legacy batchers kept for inventory parity.

The port's own copy of ``manipose_tpu/data/chunked.py`` (numpy only): the
same ``np.random.RandomState`` calls, so a seed gives the same batches bit
for bit.

- :class:`PoseGenerator`: single-frame (pose, keypoint) dataset
  (``hpe/mh_so3_hpe/data/generators.py:12-41``).
- :class:`ChunkedGenerator`: MixSTE-style chunked batcher with
  test-time flip/reverse augmentation and edge padding
  (``hpe/mh_so3_hpe/data/generator_3dhp.py:4-193``). In the reference it
  is only used by the dormant ``OriginalDataset3DHP``; provided here so
  that pipeline remains reproducible.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class PoseGenerator:
    """Flat per-frame dataset (``generators.py:12-41``)."""

    def __init__(self, poses_3d, poses_2d, actions, cams):
        if poses_3d is None:
            raise ValueError("PoseGenerator needs 3D poses")
        self._poses_3d = np.concatenate(poses_3d)
        self._poses_2d = np.concatenate(poses_2d)
        self._cams = np.concatenate(cams)
        self._actions = [a for acts in actions for a in acts]
        if not (
            self._poses_3d.shape[0] == self._poses_2d.shape[0]
            == len(self._actions) == self._cams.shape[0]
        ):
            raise ValueError("one 2D pose, action and camera per 3D pose")

    def __getitem__(self, index) -> Tuple[np.ndarray, np.ndarray]:
        return (
            self._poses_3d[index].astype(np.float32),
            self._poses_2d[index].astype(np.float32),
        )

    def __len__(self) -> int:
        return len(self._actions)


class ChunkedGenerator:
    """Chunked (pad-extended) clip batcher with optional flip/reverse
    augmentation (``generator_3dhp.py:4-193``).

    Produces batches of (cam, 3D clip, 2D clip, seq-name) like the
    reference's ``get_batch``; the pair index table includes flip and
    reverse flags when the corresponding augmentation is on.
    """

    def __init__(
        self,
        batch_size: int,
        cameras: Optional[dict],
        poses_3d: dict,
        poses_2d: dict,
        chunk_length: int = 1,
        pad: int = 0,
        causal_shift: int = 0,
        shuffle: bool = False,
        random_seed: int = 1234,
        augment: bool = False,
        reverse_aug: bool = False,
        kps_left: Optional[Sequence[int]] = None,
        kps_right: Optional[Sequence[int]] = None,
        joints_left: Optional[Sequence[int]] = None,
        joints_right: Optional[Sequence[int]] = None,
        out_all: bool = False,
        train: bool = True,
        valid_frame: Optional[dict] = None,
    ):
        if poses_3d is None:
            raise ValueError("ChunkedGenerator needs 3D poses")
        self.batch_size = batch_size
        self.cameras = cameras
        self.poses_3d = poses_3d
        self.poses_2d = poses_2d
        self.chunk_length = chunk_length
        self.pad = pad
        self.causal_shift = causal_shift
        self.shuffle = shuffle
        self.augment = augment
        self.reverse_aug = reverse_aug
        self.kps_left, self.kps_right = kps_left, kps_right
        self.joints_left, self.joints_right = joints_left, joints_right
        self.out_all = out_all
        self.rng = np.random.RandomState(random_seed)

        pairs = []  # (key, start, end, flip, reverse)
        for key in poses_2d.keys():
            n_chunks = (poses_2d[key].shape[0] + chunk_length - 1) // chunk_length
            offset = (n_chunks * chunk_length - poses_2d[key].shape[0]) // 2
            if train:
                bounds = np.arange(n_chunks + 1) * chunk_length - offset
                spans = list(zip(bounds[:-1], bounds[1:]))
            else:
                # test mode: one single-frame chunk per *valid* frame
                # (``generator_3dhp.py:38-61``)
                if valid_frame is None:
                    raise ValueError("test mode needs valid_frame")
                lows = (np.arange(n_chunks) * chunk_length - offset)[
                    np.asarray(valid_frame[key]).astype(bool)
                ]
                spans = list(zip(lows, lows + 1))
            for lo, hi in spans:
                variants = [(False, False)]
                if augment:
                    variants.append((True, False))
                if reverse_aug:
                    variants.append((False, True))
                if augment and reverse_aug:
                    variants.append((True, True))
                for flip, rev in variants:
                    pairs.append((key, lo, hi, flip, rev))
        self.pairs = pairs

    def num_frames(self) -> int:
        return sum(p.shape[0] for p in self.poses_2d.values())

    def __len__(self) -> int:
        return (len(self.pairs) + self.batch_size - 1) // self.batch_size

    def _clip(self, video: np.ndarray, start: int, end: int) -> np.ndarray:
        """Edge-padded slice (``generator_3dhp.py:120-175`` semantics)."""
        lo, hi = max(start, 0), min(end, video.shape[0])
        clip = video[lo:hi]
        pad_l, pad_r = lo - start, end - hi
        if pad_l or pad_r:
            clip = np.pad(
                clip, ((pad_l, pad_r),) + ((0, 0),) * (video.ndim - 1),
                mode="edge",
            )
        return clip

    def __iter__(self):
        order = np.arange(len(self.pairs))
        if self.shuffle:
            self.rng.shuffle(order)
        for b0 in range(0, len(order), self.batch_size):
            idx = order[b0 : b0 + self.batch_size]
            cams, p3, p2, keys = [], [], [], []
            for i in idx:
                key, start, end, flip, rev = self.pairs[i]
                start_2d = start - self.pad - self.causal_shift
                end_2d = end + self.pad - self.causal_shift
                clip_2d = self._clip(self.poses_2d[key], start_2d, end_2d)
                clip_3d = self._clip(
                    self.poses_3d[key],
                    start_2d if self.out_all else start,
                    end_2d if self.out_all else end,
                )
                if flip:
                    clip_2d = clip_2d.copy()
                    clip_3d = clip_3d.copy()
                    clip_2d[..., 0] *= -1
                    clip_3d[..., 0] *= -1
                    if self.kps_left is not None:
                        lr = list(self.kps_left) + list(self.kps_right)
                        rl = list(self.kps_right) + list(self.kps_left)
                        clip_2d[..., lr, :] = clip_2d[..., rl, :]
                    if self.joints_left is not None:
                        lr = list(self.joints_left) + list(self.joints_right)
                        rl = list(self.joints_right) + list(self.joints_left)
                        clip_3d[..., lr, :] = clip_3d[..., rl, :]
                if rev:
                    clip_2d = clip_2d[::-1].copy()
                    clip_3d = clip_3d[::-1].copy()
                cam = self.cameras[key] if self.cameras is not None else None
                if cam is not None and flip:
                    # mirror the intrinsics' x terms with the flipped pose
                    # (``generator_3dhp.py:172-176``)
                    cam = np.array(cam, copy=True)
                    cam[..., 2] *= -1
                    cam[..., 7] *= -1
                cams.append(cam)
                p3.append(clip_3d)
                p2.append(clip_2d)
                keys.append(key)
            yield cams, np.stack(p3), np.stack(p2), keys
