"""Export a model's serving forward as a ``torch.export`` program.

The port's copy of ``tools/export_model.py``, around
``Predictor.export_program``: the weights and the windows-batch forward
(model, TTA, hypothesis aggregation) in one file that
``torch.export.load`` (or ``Predictor.load_program``) runs without the
checkpoint or the model's code. The port's kernels stay in it as the
``manipose::`` operators, so the loading process must import
``manipose_tpu_torch.ops``. The window batch is symbolic unless
``--fixed-batch``. It runs on the card unless the overrides say
``device=cpu``, and the program runs where it was exported:

  python -m manipose_tpu_torch.tools.export_model --output manipose.pt2 \\
      --checkpoint manipose_h36m.pth [--verify] [device=cpu] [overrides...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# --verify: the program against the live forward, max abs difference
VERIFY_TOL = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--output", required=True, type=Path)
    ap.add_argument("--checkpoint", default="",
                    help=".pth (reference format) or a run directory of the port")
    ap.add_argument("--tag", default="best_val",
                    help="the tag of a run directory")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="the batch of the exported signature (a symbolic "
                    "export takes any size at call time)")
    ap.add_argument("--no-tta", action="store_true")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="export a fixed batch dimension instead of a symbolic one")
    ap.add_argument("--verify", action="store_true",
                    help="load the program and check it against the live forward")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides (model.arch=..., data.seq_len=..., "
                    "device=cpu)")
    args = ap.parse_args(argv)

    import torch

    from ..config import load_config
    from ..serving import Predictor

    cfg = load_config("config", overrides=args.overrides)
    kw = dict(cfg=cfg, batch_size=args.batch_size, tta=not args.no_tta,
              device=cfg.get("device", "cuda"))
    predictor = Predictor.from_any(args.checkpoint, tag=args.tag, **kw)

    data = predictor.export_program(args.output, batch_symbolic=not args.fixed_batch)
    print(f"wrote {args.output} ({len(data) / 1e6:.2f} MB, seq_len={predictor.seq_len}, "
          f"{'fixed' if args.fixed_batch else 'symbolic'} batch, "
          f"{predictor.device.type})")
    if not args.verify:
        return None
    program = Predictor.load_program(args.output)
    b = args.batch_size if args.fixed_batch else args.batch_size + 1
    x = np.random.default_rng(0).normal(
        size=(b, predictor.seq_len, predictor.skeleton.num_joints, 2)).astype(np.float32)
    got = program(x)[0]
    with torch.no_grad():
        want = predictor.serving_forward(torch.from_numpy(x).to(predictor.device))[0]
    err = float((got.float() - want.float()).abs().max())
    print(f"verify: max |program - live| = {err:.2e} at batch {b}")
    if not err < VERIFY_TOL:  # not assert: must survive python -O
        raise SystemExit(f"verification FAILED: the program deviates by {err:.2e}")
    return err


if __name__ == "__main__":
    main()
