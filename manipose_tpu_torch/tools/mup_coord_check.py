"""muP coordinate check across widths
(reference: hpe/useful_aux_scripts/mup_check.py).

The port's copy of ``tools/mup_coord_check.py``: a few Adam steps of the
MixSTE trunk (L = 27, depth 2, 4 heads, drop-path off) at several widths,
printing per step the mean |trunk features| (``MixSTE.trunk``, the full
model's weights without its head) and the mean |output|; under muP they
should be flat in width. Each width starts from the JAX tool's weights
(flax's init from ``jax.random.PRNGKey(1)``, drawn in numpy within float32
rounding of JAX's). It runs on the card unless ``--device cpu``.

  python -m manipose_tpu_torch.tools.mup_coord_check [--widths 32,64,128] \\
      [--steps 5] [--no-mup] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

L, J = 27, 17
LR = 1e-2


def build_model(width: int, base_width: int, mup: bool = True, seq_len: int = L,
                depth: int = 2, state_dict: Optional[dict] = None, seed: int = 1,
                device="cpu"):
    """The check's MixSTE (4 heads, drop-path off) at ``width``, from
    ``state_dict`` or else the JAX tool's init, ``model.init(
    jax.random.PRNGKey(seed), x)``, drawn in numpy
    (``train.init.flax_init_from_key``), on ``device``."""
    from ..models import MixSTE, MixSTEConfig
    from ..train.init import flax_init_from_key

    cfg = MixSTEConfig(num_frame=seq_len, num_joints=J, embed_dim=width, depth=depth,
                       num_heads=4, mup=mup, mup_base_width=base_width,
                       drop_path_rate=0.0)
    model = MixSTE(cfg)
    if state_dict is None:
        flax_init_from_key(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def make_check_optimizer(model, width: int, base_width: int, mup: bool):
    """muP Adam (``train.mup.make_mup_optimizer``), or plain Adam with
    ``mup=False``; no weight decay."""
    from ..train import make_optimizer
    from ..train.mup import make_mup_optimizer

    if mup:
        return make_mup_optimizer(model, width=width, base_width=base_width,
                                  weight_decay=0.0)
    return make_optimizer(model.parameters(), weight_decay=0.0)


def run(width: int, base_width: int, steps: int, mup: bool = True,
        state_dict: Optional[dict] = None, device="cuda") -> list:
    """``steps`` Adam steps at lr 1e-2 on mean((out - 1)^2) of 8 seeded
    inputs; one row a step, taken before its update: {"step", "width",
    "trunk_abs", "out_abs"}."""
    from ..device import resolve_device

    device = resolve_device(device)
    model = build_model(width, base_width, mup, state_dict=state_dict, device=device)
    model.train()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, L, J, 2)).astype(np.float32), device=device)
    opt = make_check_optimizer(model, width, base_width, mup)
    rows = []
    for step in range(steps):
        with torch.no_grad():
            feats = model.trunk(x)
            out = model(x)
        rows.append({"step": step, "width": width,
                     "trunk_abs": float(feats.abs().mean()),
                     "out_abs": float(out.abs().mean())})
        opt.zero_grad()
        torch.mean((model(x) - 1.0) ** 2).backward()
        opt.step(LR)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--widths", default="32,64,128")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no-mup", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    widths = [int(w) for w in args.widths.split(",")]
    base = widths[0]
    print(f"{'width':>6} {'step':>4} {'trunk|a|':>10} {'out|a|':>10}")
    rows = []
    for w in widths:
        for row in run(w, base, args.steps, mup=not args.no_mup, device=args.device):
            rows.append(row)
            print(f"{row['width']:>6} {row['step']:>4} "
                  f"{row['trunk_abs']:>10.4f} {row['out_abs']:>10.4f}")
    return rows


if __name__ == "__main__":
    main()
