"""Trained-outcome A/B of the segments branch's head split: ``nheads_seg``
8 (the reference's structure) against 2 (``configs/model/fast.yaml``,
the ``model=fast`` preset).

The port's copy of ``tools/seg_heads_ab.py``. Only ``model.nheads_seg``
differs between the arms (same embed dim, same block count): the port's
full stack trains twice per seed on identical FK-synthetic data at the
head-to-head protocol scale (rMCL ManifoldMixSTE d=64, depth 2, 4 heads,
segments 16 wide and 2 deep, K=3, L=27) and the arms' best validation
MPJPE, final MPJPE, MPSCE and MPSSE are compared. The protocol is this
module's own copy of the "ours" side of ``tools/h36m_head_to_head.py``
(``MODEL_KW``, ``set_scale``, ``make_split``, ``run_ours``; the H36M
protocol only): Adam lr 1e-3, wd 1e-6, the plateau scheduler, the
flagship loss (WTA + BCE + velocity + smoothness), no flip augmentation,
TTA off, ``model.init=torch``. It runs on the card unless ``--device
cpu``.

  python -m manipose_tpu_torch.tools.seg_heads_ab [--seeds 0 1 2] \\
      [--epochs 10] [--json seg_heads_ab.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

K = 3
MODEL_KW = dict(
    embed_dim_rot=64, depth_rot=2, num_heads_rot=4,
    embed_dim_seg=16, depth_seg=2, num_heads_seg=4,
    # the reference constructor defaults to 0.2 while both configs ship 0.1
    drop_path_rate=0.1,
)


@dataclasses.dataclass(frozen=True)
class Scale:
    """The shared protocol's size: frames a window, synthetic videos (a
    quarter of them validate), the model's widths."""

    frames: int = 27
    n_videos: int = 8
    model_kw: dict = dataclasses.field(default_factory=lambda: dict(MODEL_KW))


def set_scale(frames: int, dims: int, depth: int, heads, dims_seg: int, depth_seg: int,
              n_videos: int) -> Scale:
    """The protocol at another size (``h36m_head_to_head.set_scale``)."""
    return Scale(frames, n_videos, dict(
        embed_dim_rot=dims, depth_rot=depth,
        num_heads_rot=heads if heads else max(4, dims // 16),
        embed_dim_seg=dims_seg, depth_seg=depth_seg, num_heads_seg=4,
        drop_path_rate=0.1,
    ))


def make_split(seed: int, scale: Scale = Scale()):
    """((train 3D, train 2D), (val 3D, val 2D)): ``scale.n_videos``
    FK-synthetic videos of 8 windows each from seed 1000 + ``seed``,
    three quarters training."""
    from ..geometry import h36m_skeleton_17
    from .synthetic_overfit import make_videos

    videos_3d, videos_2d = make_videos(n_videos=scale.n_videos, n_frames=8 * scale.frames,
                                       skel=h36m_skeleton_17(), seed=1000 + seed)
    n_train = max(1, (3 * scale.n_videos) // 4)
    return ((videos_3d[:n_train], videos_2d[:n_train]),
            (videos_3d[n_train:], videos_2d[n_train:]))


def protocol_overrides(seed: int, epochs: int, scale: Scale) -> list:
    kw = scale.model_kw
    return [
        f"run.seed={seed}", f"data.seq_len={scale.frames}",
        f"model.channels={kw['embed_dim_rot']}", f"model.layers={kw['depth_rot']}",
        f"model.nheads={kw['num_heads_rot']}", f"model.channels_seg={kw['embed_dim_seg']}",
        f"model.layers_seg={kw['depth_seg']}", f"model.nheads_seg={kw['num_heads_seg']}",
        f"model.drop_path_rate={kw['drop_path_rate']}", f"multi_hyp.n_hyp={K}",
        f"train.epochs={epochs}", "train.lr=1e-3", "train.lr_scheduler=plateau",
        "train.lr_patience=3", "train.lr_threshold=0.1", "train.valid_epoch_interval=1",
        "train.mpjpe_epoch_interval=2", "train.tta=false", "train.batch_size=8",
        "train.batch_size_test=8", "train.flip_aug=false", "model.init=torch",
    ]


def run_ours(seed: int, train_split, val_split, epochs: int, scale: Scale = Scale(),
             device="cuda") -> dict:
    """Train the port's stack on ``train_split`` (validating on
    ``val_split``), then evaluate the best weights: {"best_val_mpjpe",
    "final_mpjpe", "mpsce", "mpsse"} (mm), the consistency metrics of the
    aggregated predictions."""
    from ..config import load_config
    from ..data import PoseSequenceDataset, SequenceLoader
    from ..device import resolve_device
    from ..drivers.common import instantiate_model
    from ..eval.engine import EvalConfig, evaluate
    from ..geometry import h36m_skeleton_17
    from ..metrics import sagittal_symmetry, segments_time_consistency
    from ..train.loop import train as train_loop

    device = resolve_device(device)
    skel = h36m_skeleton_17()
    cfg = load_config("config", protocol_overrides(seed, epochs, scale))
    model, rmcl = instantiate_model(cfg, skel)

    def loader(split, train):
        ds = PoseSequenceDataset([p.copy() for p in split[0]], [p.copy() for p in split[1]],
                                 None, seq_len=scale.frames, random_start=train,
                                 miss_type="no_miss", skeleton=skel, flip_probability=0.0)
        return SequenceLoader(ds, batch_size=8, shuffle=train, seed=seed)

    with tempfile.TemporaryDirectory() as tmp:
        result = train_loop(model, cfg, skel, loader(train_split, True),
                            loader(val_split, False), tmp, rmcl=rmcl,
                            save_checkpoints=False, device=device)
    # train() leaves the best weights in the model
    preds, _, perf, _, _, _ = evaluate(
        model, loader(val_split, False), skel,
        EvalConfig(tta=False, rmcl=True, compute_oracle=True))
    gen = torch.as_tensor(np.concatenate(preds, axis=0))  # mm
    n, l, j, _ = gen.shape
    return {
        "best_val_mpjpe": float(result.best_mpjpe),
        "final_mpjpe": float(perf),
        "mpsce": float(segments_time_consistency(gen.reshape(1, n * l, j, 3), skel,
                                                 mode="std")),
        "mpsse": float(sagittal_symmetry(gen, skel, mode="average", squared=False)),
    }


def run_ab(seeds, epochs: int, heads_a: int = 8, heads_b: int = 2, scale: Scale = None,
           device="cuda") -> dict:
    """Both arms on each seed's split: {arm name: [run_ours results],
    "protocol": {...}}."""
    if heads_a == heads_b:
        raise ValueError("the arms' head counts must differ (an A/B needs two arms)")
    # the head-to-head protocol's scale; only num_heads_seg differs per arm
    scale = scale or set_scale(frames=27, dims=64, depth=2, heads=4, dims_seg=16,
                               depth_seg=2, n_videos=8)
    arms = {f"seg{heads_a}": heads_a, f"seg{heads_b}": heads_b}
    results = {name: [] for name in arms}
    results["protocol"] = {
        "seeds": list(seeds), "epochs": epochs,
        # the per-arm num_heads_seg lives in "arms"
        "model": {k: v for k, v in scale.model_kw.items() if k != "num_heads_seg"},
        "arms": arms,
    }
    for seed in seeds:
        train_split, val_split = make_split(seed, scale)
        for name, heads in arms.items():
            arm = dataclasses.replace(scale, model_kw={**scale.model_kw,
                                                       "num_heads_seg": heads})
            print(f"=== seed {seed}: {name} ===", flush=True)
            out = run_ours(seed, train_split, val_split, epochs, arm, device)
            print(f"  -> {out}", flush=True)
            results[name].append(out)
    return results


def summary_lines(results: dict) -> list:
    names = [k for k in results if k != "protocol"]

    def stats(rows, key):
        v = np.asarray([r[key] for r in rows])
        return f"{v.mean():8.3f} ± {v.std():6.3f}"

    lines = [f"\nmetric                {names[0]:>17s} {names[1]:>21s}"]
    for key in ["best_val_mpjpe", "final_mpjpe", "mpsce", "mpsse"]:
        lines.append(f"{key:20s} {stats(results[names[0]], key)}   "
                     f"{stats(results[names[1]], key)}")
    return lines


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--heads-a", type=int, default=8,
                    help="reference structure (configs/config.yaml model.nheads_seg)")
    ap.add_argument("--heads-b", type=int, default=2,
                    help="the model=fast preset's head split")
    ap.add_argument("--json", type=Path, default=Path("seg_heads_ab.json"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.heads_a == args.heads_b:
        ap.error("--heads-a and --heads-b must differ (an A/B needs two distinct arms)")
    results = run_ab(args.seeds, args.epochs, args.heads_a, args.heads_b,
                     device=args.device)
    print("\n".join(summary_lines(results)))
    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(results, indent=1))
    print(f"\nwrote {args.json}")
    return results


if __name__ == "__main__":
    main()
