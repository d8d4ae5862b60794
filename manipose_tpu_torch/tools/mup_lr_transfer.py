"""muP learning-rate transfer demonstration.

The port's copy of ``tools/mup_lr_transfer.py``. The point of muP (the
reason the reference ships ``mup.MuAdam`` + base shapes,
``hpe/main_h36m_lifting.py:673-695``) is that the best learning rate found
on a SMALL model transfers to wider ones. This tool shows it on the MixSTE
trunk: it sweeps the learning rate at several widths under muP and
reports each width's final losses; the best rate should stay (nearly) the
same across widths, where the standard parametrization (``--sp``) drifts.
The JAX tool scans the steps under ``jit``; here they are a plain loop,
from the same initial weights for a seed (flax's init from
``jax.random.PRNGKey(seed)``, ``train.init.flax_init_from_key``). It runs
on the card unless ``--device cpu``.

  python -m manipose_tpu_torch.tools.mup_lr_transfer --widths 32 64 128 \\
      --steps 20 [--sp] [--out result.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def sweep_data(seq_len: int = 9, seed: int = 0):
    """(x (16, L, 17, 2), y (16, L, 17, 3)) from ``seed``: a learnable
    nonlinear signal (not pure noise), so that the loss keeps improving
    with training and the best learning rate is interior and sharp."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, seq_len, 17, 2)).astype(np.float32)
    y = np.stack([np.tanh(x[..., 0] * 2.0), x[..., 0] * x[..., 1],
                  np.abs(x[..., 1]) - 0.5], axis=-1).astype(np.float32)
    return x, y


def sweep_width(width, lrs, steps=20, base_width=32, depth=2, seq_len=9, mup=True,
                seed=0, state_dict: Optional[dict] = None, device="cuda") -> list:
    """Train a small MixSTE (4 heads, drop-path off) at ``width`` for
    ``steps`` Adam steps at each learning rate, each from the same initial
    weights (``state_dict``, else the JAX tool's init from
    ``jax.random.PRNGKey(seed)``, drawn in numpy); returns the final losses,
    one per rate."""
    from ..device import resolve_device
    from .mup_coord_check import build_model, make_check_optimizer

    device = resolve_device(device)
    xn, yn = sweep_data(seq_len, seed)
    x, y = torch.as_tensor(xn, device=device), torch.as_tensor(yn, device=device)
    model = build_model(width, base_width, mup, seq_len=seq_len, depth=depth,
                        state_dict=state_dict, seed=seed, device=device)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()

    def loss_fn():
        return torch.mean((model(x) - y) ** 2)

    losses = []
    for lr in lrs:
        model.load_state_dict(initial)
        opt = make_check_optimizer(model, width, base_width, mup)
        for _ in range(steps):
            opt.zero_grad()
            loss_fn().backward()
            opt.step(float(lr))
        with torch.no_grad():
            losses.append(float(loss_fn()))
    return losses


def lr_transfer(widths=(32, 64, 128), lrs=None, steps=40, mup=True, seeds=(0, 1),
                device="cuda") -> dict:
    """Sweep LR x width, each width's curve the mean over ``seeds``; the
    transfer statistic is ``transfer_gap``: how far from optimal the
    LARGEST width is when run at the SMALLEST width's best LR (the
    practical muP claim: tune small, train big)."""
    lrs = list(lrs) if lrs is not None else list(np.geomspace(3e-4, 3e-1, 8))
    curves = {}
    for w in widths:
        per_seed = [sweep_width(w, lrs, steps=steps, mup=mup, seed=s, device=device)
                    for s in seeds]
        curves[int(w)] = np.mean(np.asarray(per_seed), axis=0).tolist()
    best_idx = {w: int(np.argmin(c)) for w, c in curves.items()}
    w_small, w_large = min(curves), max(curves)
    large = np.asarray(curves[w_large])
    transfer_gap = float(large[best_idx[w_small]] / max(np.min(large), 1e-12) - 1.0)
    return {"lrs": lrs, "curves": curves, "best_idx": best_idx,
            "best_lr": {w: lrs[i] for w, i in best_idx.items()},
            "transfer_gap": transfer_gap, "mup": mup, "steps": steps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--widths", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", action="store_true",
                    help="standard parametrization instead of muP "
                         "(shows the drift muP removes)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result = lr_transfer(widths=args.widths, steps=args.steps, mup=not args.sp,
                         seeds=(args.seed, args.seed + 1), device=args.device)
    for w in args.widths:
        losses = " ".join(f"{v:.4f}" for v in result["curves"][w])
        print(f"width {w:4d}: losses [{losses}]  "
              f"best lr = {result['best_lr'][w]:.2e}")
    gap = result["transfer_gap"]
    print(f"transfer gap (small-width best LR applied at largest width): "
          f"{gap * 100:.1f}% above that width's own optimum "
          f"({'TRANSFERS' if gap < 0.10 else 'DRIFTS'})")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
