"""Consistency metrics (MPSSE/MPSCE/MPJPE/segment errors) on dumped
third-party model predictions: cross-model sanity of the metric stack
(reference: hpe/useful_aux_scripts/eval_baselines.py, which scores
PoseFormer/P-STMO dumps).

The port's copy of ``tools/eval_baselines.py``, on the port's metrics. It
prints the same lines, so that one parser reads the output of both.

Input: a .npy/.npz file with predictions of shape (N, L, J, 3) in mm and
optionally targets of the same shape.

  python -m manipose_tpu_torch.tools.eval_baselines preds.npy [targets.npy] \\
      [--skeleton=3dhp] [--pck] [--alignment=none|scale|procrustes] \\
      [--device cpu]

With --pck (and targets given) it also scores the dumps with the 3DHP
protocol: 3DPCK@150mm and AUC over 31 thresholds in [0, 150] mm
(reference: eval_baselines_mpi.py:80-116). The metrics run on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def load_array(path):
    arr = np.load(path, allow_pickle=True)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    return np.asarray(arr, np.float32)


def main(argv=None) -> None:
    from ..data.dhp3 import dhp3_skeleton
    from ..device import resolve_device
    from ..geometry import h36m_skeleton_17
    from ..metrics import (
        keypoint_3d_auc,
        keypoint_3d_pck,
        mpjpe_error,
        p_mpjpe,
        sagittal_symmetry,
        sagittal_symmetry_per_bone,
        segments_len_err,
        segments_time_consistency,
        segments_time_consistency_per_bone,
    )

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="+", help="predictions [targets]")
    ap.add_argument("--skeleton", choices=["h36m", "3dhp"], default="h36m")
    ap.add_argument("--pck", action="store_true")
    ap.add_argument("--alignment", choices=["none", "scale", "procrustes"],
                    default="none")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if len(args.paths) > 2:
        ap.error("at most two arrays: predictions and targets")
    device = resolve_device(args.device)
    skeleton = dhp3_skeleton() if args.skeleton == "3dhp" else h36m_skeleton_17()

    def host(t):
        return t.detach().cpu().numpy()

    preds = torch.as_tensor(load_array(args.paths[0]), device=device)
    if preds.ndim != 4 or preds.shape[-1] != 3:
        raise ValueError(f"predictions must be (N, L, J, 3), got {tuple(preds.shape)}")
    n, l, j, _ = preds.shape
    flat = preds.reshape(1, n * l, j, 3)

    print(f"predictions: {tuple(preds.shape)}")
    print("MPSSE (mm):", float(sagittal_symmetry(preds, skeleton, "average", squared=False)))
    print("MPSCE (mm):", float(segments_time_consistency(flat, skeleton, "std")))
    print("per-bone MPSCE:", host(segments_time_consistency_per_bone(flat, skeleton, "std")))
    print("per-bone MPSSE:",
          host(sagittal_symmetry_per_bone(preds, skeleton, "average", squared=False)))
    if len(args.paths) > 1:
        targets = torch.as_tensor(load_array(args.paths[1]), device=device)
        print("MPJPE (mm):", float(mpjpe_error(preds, targets, "average")))
        print("P-MPJPE (mm):", float(p_mpjpe(preds, targets)))
        print("segment err (mm):",
              float(segments_len_err(preds, targets, skeleton, "average", signed=False)))
        if args.pck:
            # the 3DHP protocol over pooled frames (eval_baselines_mpi.py:80-116)
            p = preds.reshape(n * l, j, 3)
            g = targets.reshape(n * l, j, 3)
            print(f"3DPCK@150mm ({args.alignment}):",
                  float(keypoint_3d_pck(p, g, alignment=args.alignment)))
            print(f"AUC 0-150mm ({args.alignment}):",
                  float(keypoint_3d_auc(p, g, alignment=args.alignment)))


if __name__ == "__main__":
    main()
