"""Streaming-accuracy study: MPJPE across (lookahead, stride) settings.

The port's copy of ``tools/streaming_eval.py``. A streaming session
(``Predictor.stream``, ``manipose_tpu_torch/streaming.py``) trades latency
for accuracy: the bidirectional trunk predicts center-window frames best,
so a small ``lookahead`` (low latency, frames predicted near the window's
trailing edge) should cost accuracy against the center default. This tool
measures that trade-off on a dataset's test split: per (lookahead, stride)
cell, every test sequence is streamed frame by frame and scored against
the ground truth (root-relative MPJPE, mm), with the offline path
(``predict_video``) as the anchor row.

It runs on the card unless the overrides say ``device=cpu``:

  python -m manipose_tpu_torch.tools.streaming_eval --checkpoint RUN_DIR \\
      --tag best_mpjpe --dataset 3dhp --lookaheads 0 4 13 --strides 1 \\
      data.data_dir=... [device=cpu] [overrides...]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def mpjpe_mm(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = pred - pred[:, :1]
    gt = gt - gt[:, :1]
    return float(np.linalg.norm(pred - gt, axis=-1).mean() * 1000.0)


def split_sequences(cfg, dataset: str):
    """(skeleton, [(3D poses in meters, 2D keypoints normalized)]) of the
    test split of ``dataset`` ("3dhp" or "h36m")."""
    if dataset == "3dhp":
        from ..data.dhp3 import Dataset3DHP

        data = Dataset3DHP(cfg.data.data_dir, train=False)
        return data.skeleton, list(zip(data.poses, data.poses_2d))
    from ..data import fetch
    from ..drivers.common import get_subjects_and_actions
    from ..drivers.h36m import fetch_and_prepare_data

    keypoints, data = fetch_and_prepare_data(cfg)
    (_, _, s_test), action_filter = get_subjects_and_actions(data, cfg)
    poses, poses_2d, _, _ = fetch(s_test, data, keypoints, action_filter)
    return data.skeleton, list(zip(poses, poses_2d))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", default="",
                    help=".pth (reference format) or a run directory of the port")
    ap.add_argument("--tag", default="best_val")
    ap.add_argument("--dataset", choices=["h36m", "3dhp"], default="3dhp")
    ap.add_argument("--lookaheads", nargs="+", type=int, default=None,
                    help="default: 0, L//8, L//2 (causal .. center)")
    ap.add_argument("--strides", nargs="+", type=int, default=[1])
    ap.add_argument("--limit-frames", type=int, default=2000,
                    help="cap frames per sequence (streaming is "
                    "one forward per stride frames)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..serving import Predictor

    base_overrides = list(args.overrides)
    if args.dataset == "3dhp":
        base_overrides = ["data=mpi_inf_3dhp"] + base_overrides
    cfg = load_config("config", overrides=base_overrides)

    skeleton, sequences = split_sequences(cfg, args.dataset)
    sequences = [
        (p3[: args.limit_frames], p2[: args.limit_frames])
        for p3, p2 in sequences
    ]
    n_frames = sum(len(p3) for p3, _ in sequences)

    kw = dict(cfg=cfg, skeleton=skeleton, batch_size=1, tta=cfg.train.tta,
              device=cfg.get("device", "cuda"))
    predictor = Predictor.from_any(args.checkpoint, tag=args.tag, **kw)
    L = predictor.seq_len
    lookaheads = (
        args.lookaheads if args.lookaheads is not None
        else sorted({0, L // 8, L // 2})
    )

    rows = []

    def record(row):
        rows.append(row)
        print(json.dumps(row))

    # anchor: the offline path
    errs = [
        mpjpe_mm(predictor.predict_video(p2), p3) * len(p3)
        for p3, p2 in sequences
    ]
    record({"mode": "offline", "lookahead": None, "stride": None,
            "mpjpe_mm": round(sum(errs) / n_frames, 3)})

    for lookahead in lookaheads:
        for stride in args.strides:
            if not 1 <= stride <= L - lookahead:
                print(f"SKIP lookahead={lookahead} stride={stride}: "
                      f"stride must be in [1, L - lookahead = "
                      f"{L - lookahead}]")
                continue
            errs = []
            for p3, p2 in sequences:
                sess = predictor.stream(stride=stride, lookahead=lookahead)
                pred = np.concatenate([sess.push(p2), sess.flush()], axis=0)
                errs.append(mpjpe_mm(pred, p3) * len(p3))
            record({
                "mode": "stream", "lookahead": lookahead, "stride": stride,
                "latency_frames": lookahead + stride - 1,
                "mpjpe_mm": round(sum(errs) / n_frames, 3),
            })

    if args.out:
        keys = ["mode", "lookahead", "stride", "latency_frames", "mpjpe_mm"]
        with open(args.out, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
