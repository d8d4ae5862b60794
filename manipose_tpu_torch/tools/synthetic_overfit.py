"""End-to-end learning validation on a synthetic-but-learnable task.

The port's copy of ``tools/synthetic_overfit.py``. ``make_videos`` makes
plausible 3D pose sequences with the port's forward kinematics (fixed
bone lengths, smooth random 6D rotation trajectories decoded in fp32 on
the CPU) and projects them to 2D with a pinhole camera; the numpy draws
are the JAX tool's, call for call, so one seed gives the same
trajectories, and the FK agrees with the JAX package's to float32
rounding (about 1e-6 m). ``main`` then trains the rMCL model to lift
2D -> 3D on the card (``--device cpu`` for the CPU). A working system
drives eval MPJPE far below the predict-zero baseline; random inputs
could never show that.

  python -m manipose_tpu_torch.tools.synthetic_overfit [--epochs 30] \
      [--small] [--seq-len 27] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..geometry import forward_kinematics, h36m_skeleton_17, rot6d_to_matrix
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


def train_and_evaluate(epochs: int = 30, seq_len: int = 27, small: bool = False,
                       device="cuda") -> dict:
    """Train the rMCL model on 6 FK-synthetic videos and evaluate it on 2
    more, as the JAX tool does (Adam at 4e-4, the velocity and smoothness
    terms on, drop-path off; bf16 compute at the flagship widths, fp32 with
    ``small``), printing its progress. Returns the predict-zero baseline
    and the untrained and final MPJPE, oracle and pseudo-oracle MPJPE (mm).
    """
    from ..data import PoseSequenceDataset, SequenceLoader
    from ..device import resolve_device
    from ..eval.engine import EvalConfig, evaluate
    from ..models import ManifoldConfig, RMCLManifoldMixSTE
    from ..train import (
        LossConfig,
        TrainState,
        flax_default_init,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(device)
    skel = h36m_skeleton_17()
    videos_3d, videos_2d = make_videos(8, 16 * seq_len, skel)
    train_ds = PoseSequenceDataset(
        videos_3d[:6], videos_2d[:6], seq_len=seq_len, random_start=True
    )
    eval_ds = PoseSequenceDataset(videos_3d[6:], videos_2d[6:], seq_len=seq_len)
    train_loader = SequenceLoader(train_ds, batch_size=16, shuffle=True, seed=0)
    eval_loader = SequenceLoader(eval_ds, batch_size=16)

    if small:
        cfg = ManifoldConfig(
            num_frame=seq_len, embed_dim_rot=64, depth_rot=3,
            num_heads_rot=4, embed_dim_seg=32, depth_seg=2, num_heads_seg=4,
            n_hyp=3, drop_path_rate=0.0,
        )
    else:
        cfg = ManifoldConfig(
            num_frame=seq_len, n_hyp=5, drop_path_rate=0.0,
            dtype=torch.bfloat16,
        )
    model = flax_default_init(RMCLManifoldMixSTE(cfg, skel), 0)
    opt = make_optimizer(model.parameters(), weight_decay=1e-6)
    state = TrainState.create(model, opt, seed=1, device=device)
    step = make_train_step(
        model, LossConfig(rmcl=True, vel_loss=2.0, smooth_reg=0.5), skel, opt,
    )
    eval_cfg = EvalConfig(tta=True, rmcl=True, compute_oracle=True)

    def run_eval():
        return evaluate(model, eval_loader, skel, eval_cfg)[2:5]

    zero_baseline = float(
        np.mean([np.linalg.norm(v, axis=-1).mean() for v in videos_3d[6:]])
    ) * 1000.0
    mpjpe0, oracle0, _ = run_eval()
    print(f"predict-zero baseline: {zero_baseline:.1f} mm", flush=True)
    print(f"untrained: mpjpe {mpjpe0:.1f} mm, oracle {oracle0:.1f} mm", flush=True)

    t0 = time.time()
    for epoch in range(epochs):
        train_loader.set_epoch(epoch)
        losses = []
        for batch in train_loader:
            losses.append(step(state, batch.pose_2d, batch.pose_3d, 4e-4)["loss"])
        if (epoch + 1) % 10 == 0 or epoch == 0:
            mpjpe, oracle, _ = run_eval()
            print(
                f"epoch {epoch + 1}: loss {float(torch.stack(losses).mean()):.4f} "
                f"eval mpjpe {mpjpe:.1f} mm oracle {oracle:.1f} mm "
                f"({time.time() - t0:.0f}s)",
                flush=True,
            )
    mpjpe_final, oracle_final, psoracle = run_eval()
    print(
        f"FINAL: mpjpe {mpjpe_final:.1f} mm (untrained {mpjpe0:.1f}, "
        f"zero-baseline {zero_baseline:.1f}), oracle {oracle_final:.1f}, "
        f"ps-oracle {psoracle:.1f}",
        flush=True,
    )
    return {"zero_baseline_mm": zero_baseline, "untrained_mpjpe_mm": mpjpe0,
            "untrained_oracle_mm": oracle0, "mpjpe_mm": mpjpe_final,
            "oracle_mm": oracle_final, "ps_oracle_mm": psoracle}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=27)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = train_and_evaluate(args.epochs, args.seq_len, args.small, args.device)
    assert report["mpjpe_mm"] < 0.5 * report["zero_baseline_mm"], (
        f"did not learn: {report['mpjpe_mm']} vs zero-baseline "
        f"{report['zero_baseline_mm']}")
    print("LEARNING VERIFIED")
    return report


if __name__ == "__main__":
    main()
