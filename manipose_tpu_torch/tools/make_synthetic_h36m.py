"""Generate an FK-synthetic Human3.6M-format dataset.

The port's copy of ``tools/make_synthetic_h36m.py``. Real H36M npz files
cannot be redistributed, so full-size driver runs use data with the same
geometry, made by the port's own kinematics: smooth random rotation
trajectories -> forward kinematics with fixed bone lengths -> world poses
on a walking root path -> projected to each subject's four real H36M
cameras (the rig's calibration, ``data/h36m_cameras.py``). The files
(``data_3d_h36m.npz``, ``data_2d_h36m_cpn_ft_h36m_dbb.npz``) feed the
driver's unmodified pipeline: 32 -> 17 joint reduction, world -> camera,
root-centering, screen normalization. So a driver run on them goes through
every real code path and can learn (the 2D is a true pinhole projection of
the 3D target). The same seed gives the JAX tool's files to float32
rounding.

  python -m manipose_tpu_torch.tools.make_synthetic_h36m --out DIR \\
      --subjects S1 S9 S11 --actions 8 --frames 3888
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data import Human36mDataset
from ..data.cameras import project_to_2d_linear, world_to_camera
from ..geometry import h36m_skeleton_17
from ..geometry.h36m import REMOVED_JOINTS_17
from .synthetic_overfit import make_videos

ACTION_NAMES = [
    "Walking", "Eating", "Smoking", "Discussion", "Directions",
    "Greeting", "Phoning", "Posing", "Purchases", "Sitting",
]
MIN_IN_FRAME = 0.95


def _root_path(n_frames: int, rng) -> np.ndarray:
    """Smooth walking path in the capture area (world frame, meters)."""
    steps = rng.normal(scale=0.01, size=(n_frames, 2)).astype(np.float32)
    # np.convolve(mode="same") returns len(kernel) when the kernel is
    # longer than the signal: clamp to an odd length <= n_frames
    k = min(61, n_frames - 1 + (n_frames % 2))
    kernel = np.hamming(max(k, 1))
    kernel /= kernel.sum()
    xy = np.cumsum(steps, axis=0)
    xy = np.apply_along_axis(
        lambda s: np.convolve(s, kernel, mode="same"), 0, xy
    )
    xy -= xy.mean(axis=0, keepdims=True)  # stay near the room center
    z = np.full((n_frames, 1), 0.9, np.float32)  # hip height
    return np.concatenate([xy.astype(np.float32), z], axis=1)


def generate(out_dir, subjects, n_actions: int, n_frames: int, seed: int = 0) -> Path:
    """Write the two npz files for ``subjects`` x the first ``n_actions``
    actions of ``n_frames`` frames into ``out_dir``. Raises when 5 % or more
    of the 2D points fall outside the cameras' frames."""
    skel = h36m_skeleton_17()
    kept = [i for i in range(32) if i not in REMOVED_JOINTS_17]
    actions = ACTION_NAMES[:n_actions]
    rng = np.random.default_rng(seed)

    positions_3d = {}
    for s_i, subject in enumerate(subjects):
        positions_3d[subject] = {}
        for a_i, action in enumerate(actions):
            (pose17,), _ = make_videos(
                1, n_frames, skel, seed=seed + 1000 * s_i + a_i
            )
            world17 = pose17 + _root_path(n_frames, rng)[:, None, :]
            p32 = np.zeros((n_frames, 32, 3), np.float32)
            p32[:, kept] = world17
            positions_3d[subject][action] = p32

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_dir / "data_3d_h36m.npz", positions_3d=positions_3d
    )

    # project through the real per-subject cameras (loaded by the same
    # dataset class the driver uses)
    dataset = Human36mDataset(out_dir / "data_3d_h36m.npz", n_joints=17)
    positions_2d = {}
    for subject in subjects:
        positions_2d[subject] = {}
        for action in actions:
            world17 = positions_3d[subject][action][:, kept]
            per_cam = []
            for cam in dataset.cameras[subject]:
                qc = world_to_camera(
                    world17, R=cam["orientation"], t=cam["translation"]
                )
                proj = np.asarray(
                    project_to_2d_linear(qc[None], cam["intrinsic"][None])
                )[0]  # normalized image coords
                # invert normalize_screen_coordinates -> raw pixels (the
                # on-disk format; create_2d_data re-normalizes)
                w, h = cam["res_w"], cam["res_h"]
                px = (proj + np.array([1.0, h / w], np.float32)) * w / 2.0
                per_cam.append(px.astype(np.float32))
            positions_2d[subject][action] = per_cam

    np.savez_compressed(
        out_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz",
        positions_2d=positions_2d,
    )
    # sanity: projections must land mostly inside the frame
    frac_in = float(np.mean([
        ((px >= 0) & (px < [cam["res_w"], cam["res_h"]])).mean()
        for subject in subjects
        for action in actions
        for cam, px in zip(
            dataset.cameras[subject], positions_2d[subject][action]
        )
    ]))
    print(f"wrote {out_dir} | subjects={list(subjects)} "
          f"actions={len(actions)} frames={n_frames} "
          f"in-frame fraction={frac_in:.3f}")
    if not frac_in > MIN_IN_FRAME:
        raise RuntimeError(
            f"synthetic poses project outside the cameras (in-frame "
            f"fraction {frac_in:.3f} <= {MIN_IN_FRAME})"
        )
    return out_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--subjects", nargs="+", default=["S1", "S9", "S11"])
    ap.add_argument("--actions", type=int, default=8)
    ap.add_argument("--frames", type=int, default=3888)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    generate(args.out, args.subjects, args.actions, args.frames, args.seed)


if __name__ == "__main__":
    main()
