"""The training cells' comparison with the reference.

The program's first steps (fed by its own loader) are followed by the
reference (the configuration's architecture's ``train_steps``) from the
same weights, on the same rows and with drop-path masks drawn as the
program draws them. Compared:

- ``loss_gap``: the first step's total loss, the relative gap;
- ``grad_gap``: the first step's gradient of every leaf as Adam took it
  (the program's read from Adam's first moment after one step), by the
  worst leaf: |norm(program) - norm(reference)| over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_gap``: each leaf's change over the steps, measured so, the
  median leaf; elements whose reference gradient is under a thousandth of
  the median leaf's root-mean-square gradient (a key's bias under
  softmax) move by round-off alone under Adam and are left out;
- ``feed_rows_bad``: rows of the fed batches that are no window of the
  archive (each flipped or not, as one in 2D and 3D), or repeat another.

The later steps' losses and the worst leaf's change are printed beside
them, not compared: where the winner-takes-all loss's argmin over the K
hypotheses is tied to rounding in some frame, the program and the
reference send that frame's gradient to different heads, and from the
second step on they take two steps that are both sound (PERF.md).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import core, reference

BETA1 = 0.9


def first_gradients(optimizer, names) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as Adam took it: its first moment after
    one step over (1 - beta1), on the host; zero where Adam took none."""
    from manipose_tpu_torch.parallel.mesh import local_part

    out = {}
    for p in optimizer.params:
        st = optimizer.adam.state.get(p)
        m = local_part(st["exp_avg"]) if st else torch.zeros_like(local_part(p))
        out[names[id(p)]] = (m / (1 - BETA1)).to("cpu", copy=True)
    return out


def _leaf_gaps(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: Dict[str, torch.Tensor] = None) -> Dict[str, float]:
    def norm(t, k):
        t = t.double()
        if keep is not None:
            t = t[keep[k]]
        return float(torch.linalg.vector_norm(t))

    ref_norms = {k: norm(ref[k], k) for k in ref}
    median = float(np.median(list(ref_norms.values())))
    return {k: abs(norm(program[k], k) - ref_norms[k]) / max(ref_norms[k], median)
            if k in program else float("inf") for k in ref}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    leaf = max(gaps, key=lambda k: (not np.isfinite(gaps[k]), gaps[k]))
    return gaps[leaf], leaf


def find_rows(fed, archive, skeleton: dict, device) -> int:
    """How many fed rows are not a window of the archive, or repeat one."""
    seq_len = fed[0][0].shape[1]
    kp = torch.from_numpy(np.concatenate([k for k, _ in archive])).to(device)
    poses = np.concatenate([p for _, p in archive])
    ends = np.cumsum([len(k) for k, _ in archive])
    flat = kp.reshape(len(kp), -1)
    seen, bad = set(), 0
    for x2d, x3d in fed:
        for x, y in zip(x2d, x3d):
            hit = None
            for flipped in (False, True):
                want2 = reference.flip(torch.from_numpy(x), skeleton).numpy() if flipped else x
                key = torch.from_numpy(np.ascontiguousarray(want2[0])).to(device).reshape(-1)
                for s in torch.nonzero((flat == key).all(dim=1)).flatten().tolist():
                    end = ends[np.searchsorted(ends, s, side="right")]
                    if s + seq_len > end:
                        continue
                    want3 = reference.flip(torch.from_numpy(y), skeleton).numpy() if flipped else y
                    if (np.array_equal(kp[s:s + seq_len].cpu().numpy(), want2)
                            and np.array_equal(poses[s:s + seq_len], want3)):
                        hit = (s, flipped)
                        break
                if hit:
                    break
            if hit is None or hit in seen:
                bad += 1
            else:
                seen.add(hit)
    return bad


def follow(ctx, fed: Sequence, drop_seeds: Sequence[int], tf32: bool = False,
           fault: str = "") -> dict:
    """The reference's steps on the fed rows from the drawn weights, one
    data-parallel rank a drop-path seed. With ``tf32`` or a ``fault`` it
    stands in for the program (``controls.py``): ``half_batch`` steps on
    the first half of each rank's rows, ``no_exchange`` on rank 0's rows
    alone (its gradient never averaged with the others')."""
    device = ctx.device
    arch = ctx.arch
    p = arch.draw(ctx.config, ctx.seed, device)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in drop_seeds]
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)) for x, y in fed]
    if fault == "half_batch":
        n = len(gens)
        batches = [tuple(torch.cat([c[: len(c) // 2] for c in t.chunk(n)]) for t in b)
                   for b in batches]
    elif fault == "no_exchange":
        batches = [tuple(t.chunk(len(gens))[0] for t in b) for b in batches]
        gens = gens[:1]
    with reference.matmul_precision(tf32):
        return arch.train_steps(p, ctx.config, batches, gens)


def train_numbers(ctx, fed: Sequence, program_losses: List[float], snapshots: dict,
                  drop_seeds: Sequence[int]) -> Dict[str, float]:
    """Every number above but ``feed_rows_bad``, of the program's losses and
    ``snapshots`` (``first_grads`` and the leaves ``after`` the steps)
    against the reference's."""
    device = ctx.device
    cfg = ctx.config
    ref = follow(ctx, fed, drop_seeds)
    gaps = [abs(a - b) / abs(b) for a, b in zip(program_losses, ref["losses"])]
    ref_grads = {k: v.cpu() for k, v in ref["first_grads"].items()}
    grad_gap, grad_leaf = _worst(_leaf_gaps(snapshots["first_grads"], ref_grads))
    rms = [float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
           for g in ref_grads.values()]
    floor = 1e-3 * float(np.median(rms))
    keep = {k: g.abs() >= floor for k, g in ref_grads.items()}
    start = {k: v.cpu() for k, v in ctx.arch.draw(cfg, ctx.seed, device).items()}
    program_change = {k: snapshots["after"][k] - start[k] for k in start if k in snapshots["after"]}
    ref_change = {k: v.cpu() for k, v in ref["change"].items()}
    change = _leaf_gaps(program_change, ref_change, keep)
    worst_change, change_leaf = _worst(change)
    print(f"train check: loss gaps by step {[float(g) for g in gaps]}; worst gradient leaf "
          f"{grad_leaf}; worst change leaf {change_leaf} {worst_change}", file=sys.stderr)
    return {"loss_gap": gaps[0], "grad_gap": grad_gap,
            "change_gap": float(np.median(list(change.values())))}


def train_checks(ctx, fed: Sequence, program_losses: List[float], snapshots: dict,
                 archive, drop_seeds: Sequence[int]) -> List[core.Check]:
    """The numbers above, each with the mix's limit; ``archive``: the rows'
    source, None to skip ``feed_rows_bad``."""
    limits = ctx.mix["limits"]
    numbers = train_numbers(ctx, fed, program_losses, snapshots, drop_seeds)
    out = [core.Check(k, v, limits[k]) for k, v in numbers.items()]
    if archive is not None:
        bad = find_rows(fed, archive, ctx.config["skeleton"], ctx.device)
        out.append(core.Check("feed_rows_bad", float(bad), 0.0))
    return out
