"""Batch-inference CLI: lift 2D keypoint videos to 3D poses.

The port's copy of ``tools/predict.py``, around
:class:`manipose_tpu_torch.serving.Predictor`. It runs on the card unless
the overrides say ``device=cpu``:

  python -m manipose_tpu_torch.tools.predict --input keypoints.npz \\
      --output poses.npz --checkpoint manipose_h36m.pth [--int8] \\
      [--window-stride S] [--hypotheses] [device=cpu] [overrides...]

Input: an .npz with one or more (N, J, 2) screen-normalized 2D keypoint
videos (one entry each), or an .npy holding one. Output: an .npz with a
(N, J, 3) root-relative 3D pose array (meters) per video, and with
``--hypotheses`` each video's per-window hypotheses and scores.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def load_videos(path: Path):
    if path.suffix == ".npy":
        return {"video": np.load(path)}
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True, type=Path,
                    help=".npz/.npy of (N, J, 2) 2D keypoint videos")
    ap.add_argument("--output", required=True, type=Path)
    ap.add_argument("--checkpoint", default="",
                    help=".pth (reference format) or a run directory of the port")
    ap.add_argument("--tag", default="best_val",
                    help="the tag of a run directory")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--no-tta", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight+activation serving path")
    ap.add_argument("--window-stride", type=int, default=None,
                    help="quality mode: overlapping windows advancing this "
                    "many frames, read from the window's centre (<= ceil(L/2))")
    ap.add_argument("--hypotheses", action="store_true",
                    help="also write the per-window hypotheses and scores")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides (model.arch=..., data.seq_len=..., "
                    "device=cpu)")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..serving import Predictor

    cfg = load_config("config", overrides=args.overrides)
    kw = dict(cfg=cfg, batch_size=args.batch_size, tta=not args.no_tta,
              quantize=args.int8, device=cfg.get("device", "cuda"))
    predictor = Predictor.from_any(args.checkpoint, tag=args.tag, **kw)

    if args.hypotheses and not predictor.rmcl:
        print("WARNING: --hypotheses requested but the model is not an rMCL "
              "multi-hypothesis architecture; no *_hypotheses/*_scores arrays "
              "will be written")
    videos = load_videos(args.input)
    out = {}
    t0 = time.perf_counter()
    n_frames = 0
    for name, kps in videos.items():
        if kps.ndim != 3 or kps.shape[-1] != 2:
            raise ValueError(f"{name}: expected (N, J, 2), got {kps.shape}")
        n_frames += kps.shape[0]
        if args.hypotheses and predictor.rmcl:
            poses, hyps, scores = predictor.predict_video(
                kps, return_hypotheses=True, window_stride=args.window_stride)
            out[f"{name}_hypotheses"] = hyps
            out[f"{name}_scores"] = scores
        else:
            poses = predictor.predict_video(kps, window_stride=args.window_stride)
        out[name] = poses
    dt = time.perf_counter() - t0
    args.output.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.output, **out)
    print(f"lifted {len(videos)} video(s) / {n_frames} frames in {dt:.2f}s "
          f"({n_frames / dt:.0f} frames/s, {predictor.device.type}"
          f"{', int8' if predictor.quantized else ''}) -> {args.output}")


if __name__ == "__main__":
    main()
