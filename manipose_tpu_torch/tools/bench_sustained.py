"""Sustained training throughput INCLUDING the host input pipeline.

The port's copy of ``tools/bench_sustained.py``. ``chip_smoke.py`` times
the blocked train step alone; this tool runs real epochs through
``PoseSequenceDataset`` -> ``SequenceLoader`` -> ``prefetch`` (a host
thread) -> the train step, on synthetic videos, so it shows any
input-pipeline bottleneck. The model is the flagship rMCL model in bf16
(fp32 parameters), drawn by flax's init from seed 0; only full batches
are timed and counted, and the timed window ends in a host read of the
last loss and a device synchronisation.

  python -m manipose_tpu_torch.tools.bench_sustained [--epochs 2] \\
      [--batch 16] [--videos 40] [--steps-per-call K] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--videos", type=int, default=40)
    ap.add_argument("--frames", type=int, default=700)
    ap.add_argument("--seq-len", type=int, default=243)
    ap.add_argument(
        "--steps-per-call", type=int, default=1,
        help="K optimizer steps per call (the megastep: one CUDA graph of K "
        "steps on the card)",
    )
    ap.add_argument(
        "--nheads-seg", type=int, default=8,
        help="segments-branch heads: 8 = reference structure",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data import PoseSequenceDataset, SequenceLoader
    from ..data.pipeline import prefetch
    from ..device import resolve_device
    from ..geometry import h36m_skeleton_17
    from ..models import ManifoldConfig, RMCLManifoldMixSTE
    from ..train import (
        LossConfig,
        TrainState,
        flax_default_init,
        make_multi_train_step,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(args.device)
    skel = h36m_skeleton_17()
    rng = np.random.default_rng(0)
    vids3d = [
        rng.normal(scale=0.3, size=(args.frames, 17, 3)).astype(np.float32)
        for _ in range(args.videos)
    ]
    vids2d = [v[..., :2].copy() for v in vids3d]
    ds = PoseSequenceDataset(vids3d, vids2d, seq_len=args.seq_len,
                             random_start=True)
    loader = SequenceLoader(ds, batch_size=args.batch, shuffle=True, seed=0,
                            drop_last=True)

    cfg = ManifoldConfig(
        num_frame=args.seq_len, n_hyp=5, dtype=torch.bfloat16,
        num_heads_seg=args.nheads_seg,
    )
    model = flax_default_init(RMCLManifoldMixSTE(cfg, skel), 0)
    opt = make_optimizer(model.parameters(), weight_decay=1e-6)
    state = TrainState.create(model, opt, seed=1, device=device)
    K = args.steps_per_call
    step = make_train_step(model, LossConfig(rmcl=True), skel, opt)
    multi = (
        make_multi_train_step(model, LossConfig(rmcl=True), skel, opt, K)
        if K > 1
        else None
    )

    def to_device(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    # warm-up: one batch without prefetch() (an abandoned prefetch would
    # leave its producer thread waiting)
    batch0 = next(iter(loader))
    if multi is not None:
        m = multi(state, to_device([batch0.pose_2d] * K),
                  to_device([batch0.pose_3d] * K), 4e-5)
        _ = float(m["loss"][-1])
    else:
        m = step(state, batch0.pose_2d, batch0.pose_3d, 4e-5)
        _ = float(m["loss"])

    n_seq = 0
    pending = []
    t0 = time.perf_counter()
    for _ in range(args.epochs):
        for batch in prefetch(loader):
            if multi is not None:
                pending.append((batch.pose_2d, batch.pose_3d))
                if len(pending) == K:
                    xs = to_device([p[0] for p in pending])
                    ys = to_device([p[1] for p in pending])
                    m = multi(state, xs, ys, 4e-5)
                    n_seq += int(xs.shape[0] * xs.shape[1])
                    pending.clear()
            else:
                m = step(state, batch.pose_2d, batch.pose_3d, 4e-5)
                n_seq += batch.pose_2d.shape[0]
    loss_last = m["loss"] if multi is None else m["loss"][-1]
    _ = float(loss_last)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    record = {
        "metric": "rmcl_manipose_sustained_train_throughput",
        "value": round(n_seq / dt, 3),
        "unit": "seq/s",
        "n_sequences": n_seq,
        "seq_len": args.seq_len,
        "steps_per_call": K,
        "nheads_seg": args.nheads_seg,
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
