"""Ablation profile of the flagship train step.

The port's copy of ``tools/step_ablation.py``. A profiler answers "what
does one step spend its time on"; this tool answers the coarser planning
question "what would the step cost WITHOUT subsystem X" by timing ablated
variants of the whole bf16 train step (B=16, L=243, Adam) on the card:

    full          — RMCLManifoldMixSTE, the flagship configuration
    no_seg        — segments branch replaced by constant bone lengths
    no_decode     — raw rotation slices in place of FK decode (+no seg)
    k1            — a single hypothesis head instead of n_hyp
    depth4        — half the rotations trunk's depth
    no_droppath   — stochastic depth off
    fwd           — the train-mode forward + loss alone (no grad, no update)
    remat         — the trunks' blocks recomputed in the backward pass

Marginal costs are reported as deltas against ``full``. Each variant's
steps are timed with CUDA events after 3 warm-up steps, each drained by a
host read of its loss (``--device cpu``: the host clock, ending in a read
of the last loss).

  python -m manipose_tpu_torch.tools.step_ablation [--batch 16] [--steps 20] \\
      [--ablations full,no_seg,no_decode,k1] [--device cpu]

The JAX tool's ``--pack-group`` (XLA's spatial packing width) has no
counterpart: the port's per-window attention kernel packs no group.
In ``no_seg`` the segments parameters get no gradient, so Adam skips them
(optax updates them with zero gradients and weight decay): a difference
of the optimizer's few segments tensors, not of the ablated forward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch import nn

from ..geometry.skeleton import Skeleton
from ..models import (
    ManifoldConfig,
    RMCLManifoldMixSTE,
    RMCLRotMixSTE,
    decode_poses,
)

ABLATIONS = ("full", "no_seg", "no_decode", "k1", "depth4", "no_droppath",
             "fwd", "remat")
WARMUP_STEPS = 3


class RMCLNoSeg(RMCLManifoldMixSTE):
    """Segments branch ablated to unit bone lengths; its parameters are
    kept (the state dict is the full model's)."""

    def forward(self, x: torch.Tensor):
        rotations, scores = self.rotations_module(x)
        lengths = rotations.new_ones((x.shape[0], 1, 1, self.cfg.num_bones))
        roots = rotations.new_zeros(rotations.shape[:-2] + (3,))
        poses = decode_poses(
            rotations, lengths, roots, self.skeleton, self.cfg.rot_rep_dim
        )
        return poses, scores


class RMCLNoDecode(nn.Module):
    """FK decode ablated: the first 3 rotation channels stand in for poses
    (also drops the segments branch — decode is its only consumer). Its
    state dict is the full model's ``rotations_module.*`` part."""

    def __init__(self, cfg: ManifoldConfig, skeleton: Skeleton):
        super().__init__()
        self.cfg = cfg
        self.skeleton = skeleton
        self.rotations_module = RMCLRotMixSTE(cfg)

    def forward(self, x: torch.Tensor):
        rots, scores = self.rotations_module(x)
        return rots[..., :3], scores


def build(name: str, cfg: ManifoldConfig, skel: Skeleton) -> nn.Module:
    """The ablation's model (``fwd`` times the full one), drawn by flax's
    init from seed 0."""
    from ..train import flax_default_init

    if name in ("full", "fwd"):
        model = RMCLManifoldMixSTE(cfg, skel)
    elif name == "no_seg":
        model = RMCLNoSeg(cfg, skel)
    elif name == "no_decode":
        model = RMCLNoDecode(cfg, skel)
    elif name == "k1":
        model = RMCLManifoldMixSTE(dataclasses.replace(cfg, n_hyp=1), skel)
    elif name == "depth4":
        model = RMCLManifoldMixSTE(dataclasses.replace(cfg, depth_rot=4), skel)
    elif name == "no_droppath":
        model = RMCLManifoldMixSTE(dataclasses.replace(cfg, drop_path_rate=0.0), skel)
    elif name == "remat":
        model = RMCLManifoldMixSTE(dataclasses.replace(cfg, remat=True), skel)
    else:
        raise ValueError(name)
    return flax_default_init(model, 0)


def _per_call(fn, steps: int, device: torch.device) -> float:
    """Seconds per call of ``fn`` (which returns a 0-dim loss) over
    ``steps`` calls after the warm-ups."""
    for _ in range(WARMUP_STEPS):
        _ = float(fn())
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            loss = fn()
        end.record()
        end.synchronize()
        _ = float(loss)
        return start.elapsed_time(end) / 1e3 / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = fn()
    _ = float(loss)
    return (time.perf_counter() - t0) / steps


def time_ablation(name: str, cfg: ManifoldConfig, skel: Skeleton, x: torch.Tensor,
                  y: torch.Tensor, steps: int, device: torch.device) -> float:
    """Seconds per train step (``fwd``: per forward + loss) of the
    ablation ``name`` on (x, y), on ``device``."""
    from ..train import (
        LossConfig,
        TrainState,
        compute_loss,
        make_optimizer,
        make_train_step,
    )

    model = build(name, cfg, skel)
    opt = make_optimizer(model.parameters(), weight_decay=1e-6)
    state = TrainState.create(model, opt, seed=1, device=device)
    loss_cfg = LossConfig(rmcl=True)
    if name == "fwd":
        model.train()

        def call():
            with torch.no_grad():
                return compute_loss(model(x), y, loss_cfg, skel)[0]
    else:
        step = make_train_step(model, loss_cfg, skel, opt)

        def call():
            return step(state, x, y, 4e-5)["loss"]
    return _per_call(call, steps, device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=243)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument(
        "--ablations",
        default="full,no_seg,no_decode,k1",
        help=f"comma list from {{{','.join(ABLATIONS)}}} — depth4 halves the "
        "trunk depth (per-block-pair marginal = (full - depth4)/4), "
        "no_droppath zeroes stochastic depth (its train-mode mask cost), fwd "
        "times the train-mode forward+loss alone (no grad, no optimizer)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..geometry import h36m_skeleton_17

    device = resolve_device(args.device)
    skel = h36m_skeleton_17()
    cfg = ManifoldConfig(num_frame=args.seq_len, n_hyp=5, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.normal(size=(args.batch, args.seq_len, 17, 2)).astype(np.float32)
    ).to(device)
    y = torch.from_numpy(
        0.1 * rng.normal(size=(args.batch, args.seq_len, 17, 3)).astype(np.float32)
    ).to(device)

    results = {}
    names = [n.strip() for n in args.ablations.split(",") if n.strip()]
    for name in names:
        dt = time_ablation(name, cfg, skel, x, y, args.steps, device)
        results[name] = {
            "ms_per_step": round(dt * 1e3, 3),
            "seq_per_sec": round(args.batch / dt, 2),
        }
        print(f"{name}: {dt * 1e3:.3f} ms/step  {args.batch / dt:.2f} seq/s",
              flush=True)

    if "full" in results:
        base = results["full"]["ms_per_step"]
        for name, r in results.items():
            if name != "full":
                r["marginal_ms"] = round(base - r["ms_per_step"], 3)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
