"""Generate an FK-synthetic MPI-INF-3DHP-format dataset.

The port's copy of ``tools/make_synthetic_3dhp.py``. Real 3DHP archives
cannot be redistributed, so full-size 3DHP driver runs use data with the
same geometry, made by the port's own kinematics: smooth random rotation
trajectories -> forward kinematics with fixed bone lengths ->
camera-frame poses on a wandering root path -> pinhole projection to the
real sensor rasters (2048x2048 train and test, 1920x1080 for TS5/TS6).
The archives are in the reference's on-disk layout: MPI joint order,
millimetres, raw pixel 2D, ``valid`` masks on the test split
(``hpe/mh_so3_hpe/data/dataset_3dhp.py:146-221``). So ``Dataset3DHP``
reads them through the production path (permute -> root-center -> /1000
-> screen-normalize), and the 2D input is a true projection of the 3D
target: the lifting task is learnable. The same seed gives the JAX tool's
archives to float32 rounding.

  python -m manipose_tpu_torch.tools.make_synthetic_3dhp --out DIR \\
      --train-seqs 6 --cams 2 --frames 2000 --test-frames 1500
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.dhp3 import MAP_H36M_TO_MPI_JOINTS, raster
from ..geometry import h36m_skeleton_17
from .synthetic_overfit import make_videos

# pinhole intrinsics per raster (fx=fy, principal point at center):
# ~74 deg horizontal field of view, the class of lens the real rig uses
INTRINSICS = {
    (2048, 2048): (1365.0, 1024.0, 1024.0),
    (1920, 1080): (1280.0, 960.0, 540.0),
}
TEST_SEQUENCES = ("TS1", "TS2", "TS3", "TS4", "TS5", "TS6")
MIN_IN_FRAME = 0.95


def _h36m_to_mpi(pose_h36m: np.ndarray) -> np.ndarray:
    """Invert the loader's ``pose[:, MAP_H36M_TO_MPI_JOINTS]`` permute."""
    mpi = np.empty_like(pose_h36m)
    mpi[:, list(MAP_H36M_TO_MPI_JOINTS)] = pose_h36m
    return mpi


def _root_path(n_frames: int, rng) -> np.ndarray:
    """Smooth camera-frame root trajectory: wander in x/y, depth 3.5-4.5 m."""
    steps = rng.normal(scale=0.008, size=(n_frames, 3)).astype(np.float32)
    # np.convolve(mode="same") returns len(kernel) when the kernel is the
    # longer operand: clamp it below n_frames for short sequences
    k = min(61, n_frames - 1 + (n_frames % 2))
    kernel = np.hamming(max(k, 1))
    kernel /= kernel.sum()
    path = np.cumsum(steps, axis=0)
    path = np.apply_along_axis(
        lambda s: np.convolve(s, kernel, mode="same"), 0, path
    )[:n_frames]
    path -= path.mean(axis=0, keepdims=True)
    path[:, 2] = 4.0 + 0.5 * np.tanh(path[:, 2] * 4.0)  # depth in [3.5, 4.5]
    return path.astype(np.float32)


def _make_sequence(n_frames: int, wh: tuple, seed: int):
    """One camera-frame sequence: (data_3d mm MPI-order, data_2d px)."""
    rng = np.random.default_rng(seed)
    (pose17,), _ = make_videos(1, n_frames, h36m_skeleton_17(), seed=seed)
    cam_pose = pose17 + _root_path(n_frames, rng)[:, None, :]  # meters

    f, cx, cy = INTRINSICS[wh]
    z = cam_pose[..., 2]
    px = np.stack(
        [f * cam_pose[..., 0] / z + cx, f * cam_pose[..., 1] / z + cy],
        axis=-1,
    ).astype(np.float32)

    data_3d = _h36m_to_mpi(cam_pose * 1000.0).astype(np.float32)  # mm
    data_2d = _h36m_to_mpi(px)
    return data_3d, data_2d


def _in_frame_fraction(data_2d: np.ndarray, wh: tuple) -> float:
    return float(
        ((data_2d >= 0) & (data_2d < np.asarray(wh, np.float32))).mean()
    )


def generate(out_dir, train_seqs: int = 6, cams: int = 2, frames: int = 2000,
             test_frames: int = 1500, seed: int = 0) -> Path:
    """Write ``data_train_3dhp.npz`` (``train_seqs`` sequences x ``cams``
    cameras x ``frames`` frames) and ``data_test_3dhp.npz`` (TS1-TS6 of
    ``test_frames`` frames, about 5 % of them invalid) into ``out_dir``.
    Raises when 5 % or more of the 2D points fall outside the sensors."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fracs = []

    # train archive: data[seq][0][cam] = {data_3d, data_2d}
    train = {}
    for s in range(train_seqs):
        by_cam = {}
        for c in range(cams):
            d3, d2 = _make_sequence(
                frames, (2048, 2048), seed=seed + 100 * s + c
            )
            by_cam[str(c)] = {"data_3d": d3, "data_2d": d2}
            fracs.append(_in_frame_fraction(d2, (2048, 2048)))
        train[f"S{s + 1} Seq1"] = {0: by_cam}
    np.savez_compressed(out_dir / "data_train_3dhp.npz", data=train)

    # test archive: TS1..TS6 with valid masks; TS5/TS6 are 1920x1080
    test = {}
    rng = np.random.default_rng(seed + 7777)
    for i, seq in enumerate(TEST_SEQUENCES):
        wh = raster(seq)
        d3, d2 = _make_sequence(test_frames, wh, seed=seed + 9000 + i)
        valid = (rng.uniform(size=test_frames) > 0.05).astype(np.float64)
        valid[:3] = 0.0  # deterministic leading-invalid stretch
        test[seq] = {"valid": valid, "data_3d": d3, "data_2d": d2}
        fracs.append(_in_frame_fraction(d2, wh))
    np.savez_compressed(out_dir / "data_test_3dhp.npz", data=test)

    frac_in = float(np.mean(fracs))
    print(
        f"wrote {out_dir} | train_seqs={train_seqs} cams={cams} "
        f"frames={frames} test_frames={test_frames} "
        f"in-frame fraction={frac_in:.3f}"
    )
    if not frac_in > MIN_IN_FRAME:
        raise RuntimeError(
            f"synthetic poses project outside the sensors (in-frame "
            f"fraction {frac_in:.3f} <= {MIN_IN_FRAME})"
        )
    return out_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--train-seqs", type=int, default=6)
    ap.add_argument("--cams", type=int, default=2)
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--test-frames", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    generate(args.out, args.train_seqs, args.cams, args.frames,
             args.test_frames, args.seed)


if __name__ == "__main__":
    main()
