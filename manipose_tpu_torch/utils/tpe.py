"""Tree-structured Parzen Estimator (TPE) hyper-parameter search.

The port's own copy of ``manipose_tpu/utils/tpe.py`` (numpy only): the
same draws in the same order, so one seed and history give the same
proposals and the same journal.

The reference ships hydra-optuna-sweeper with ``main`` returning
``best_valid_mpjpe`` as the objective
(``hpe/main_h36m_lifting.py:1264-1266``, ``requirements.txt:6``) — i.e.
Optuna's default TPE sampler over the config space. Optuna is not a
dependency, so this module implements the same algorithm (Bergstra et
al., NeurIPS 2011) natively:

  - the first ``n_startup`` trials are sampled uniformly;
  - afterwards observations are split into a "good" elite set (the best
    ceil(gamma*sqrt(n)) trials, hyperopt's schedule) and a "rest" set,
    each modeled by a Parzen estimator (per-dimension adaptive-bandwidth
    Gaussian KDE for numeric params, smoothed categorical for choices);
  - candidates drawn from the good-set estimator l(x) are ranked by the
    acquisition l(x)/g(x) and the best one is proposed.

Sweep state persists to a JSONL journal so interrupted sweeps resume.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Param:
    """One dimension: kind in {uniform, loguniform, int, choice}."""

    name: str
    kind: str
    low: float = 0.0
    high: float = 1.0
    choices: Tuple[str, ...] = ()

    @classmethod
    def parse(cls, name: str, spec: str) -> "Param":
        kind, _, args = spec.partition(":")
        if kind == "choice":
            return cls(name, kind, choices=tuple(args.split(",")))
        lo, hi = (float(x) for x in args.split(","))
        if kind not in ("uniform", "loguniform", "int"):
            raise ValueError(f"unknown space kind: {kind}")
        return cls(name, kind, low=lo, high=hi)

    # -- numeric transform: TPE models ints/floats in a continuous space,
    # loguniform in log-space --------------------------------------------
    def to_internal(self, value):
        if self.kind == "choice":
            return self.choices.index(str(value))
        v = float(value)
        return math.log(v) if self.kind == "loguniform" else v

    def from_internal(self, x: float):
        if self.kind == "choice":
            return self.choices[int(x)]
        if self.kind == "loguniform":
            v = math.exp(x)
            return float(min(max(v, self.low), self.high))
        if self.kind == "int":
            return int(round(min(max(x, self.low), self.high)))
        return float(min(max(x, self.low), self.high))

    @property
    def internal_bounds(self) -> Tuple[float, float]:
        if self.kind == "loguniform":
            return math.log(self.low), math.log(self.high)
        return self.low, self.high

    def sample_uniform(self, rng: np.random.Generator):
        if self.kind == "choice":
            return str(rng.choice(self.choices))
        lo, hi = self.internal_bounds
        return self.from_internal(float(rng.uniform(lo, hi)))


def parse_space(specs: Sequence[str]) -> List[Param]:
    """["train.lr=loguniform:1e-4,1e-2", "m.h=choice:16,32"] -> [Param]"""
    out = []
    for s in specs:
        name, _, spec = s.partition("=")
        out.append(Param.parse(name, spec))
    return out


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
class RandomSampler:
    def __init__(self, space: List[Param], seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)

    def suggest(self, history) -> Dict[str, object]:
        return {p.name: p.sample_uniform(self.rng) for p in self.space}


class TPESampler:
    """Independent per-dimension TPE (Optuna-default style)."""

    def __init__(self, space: List[Param], seed: int = 0,
                 n_startup: int = 5, gamma: float = 0.25,
                 n_candidates: int = 48):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- Parzen pieces ----------------------------------------------------
    def _numeric_kde(self, xs: np.ndarray, bounds):
        """Adaptive per-point bandwidths (Bergstra et al.): each kernel's
        width is the max distance to its neighbors (with virtual
        neighbors at the bounds), so kernels stay wide where points are
        sparse and narrow only inside dense clusters — this is what keeps
        the sampler from locking onto the first local optimum."""
        lo, hi = bounds
        span = hi - lo if hi > lo else 1.0
        order = np.argsort(xs)
        sorted_xs = xs[order]
        padded = np.concatenate([[lo], sorted_xs, [hi]])
        left = padded[1:-1] - padded[:-2]
        right = padded[2:] - padded[1:-1]
        bw_sorted = np.clip(np.maximum(left, right), 0.01 * span, span)
        bw = np.empty_like(bw_sorted)
        bw[order] = bw_sorted
        return xs, bw

    def _numeric_logpdf(self, x, centers, bw, bounds):
        """Parzen mixture of the kernels PLUS one uniform prior component
        over the bounds (Optuna-style), so the ratio l/g never fully
        collapses onto exploited regions."""
        lo, hi = bounds
        span = hi - lo if hi > lo else 1.0
        z = (x - centers[:, None]) / bw[:, None]
        comp = -0.5 * z * z - np.log(
            bw[:, None] * math.sqrt(2 * math.pi)
        )
        prior = np.full((1, len(x)), -math.log(span))
        comp = np.concatenate([comp, prior], axis=0)
        m = comp.max(axis=0)
        return m + np.log(np.exp(comp - m).mean(axis=0))

    def _suggest_numeric(self, p: Param, good: np.ndarray, rest: np.ndarray):
        bounds = p.internal_bounds
        centers, bw = self._numeric_kde(good, bounds)
        # draw candidates from l(x): pick a component (incl. the uniform
        # prior), add its kernel's noise
        n_uniform = max(1, self.n_candidates // 4)
        picks = self.rng.integers(0, len(centers),
                                  size=self.n_candidates - n_uniform)
        cands = centers[picks] + self.rng.normal(
            0, 1.0, self.n_candidates - n_uniform
        ) * bw[picks]
        cands = np.concatenate(
            [cands, self.rng.uniform(*bounds, size=n_uniform)]
        )
        cands = np.clip(cands, *bounds)
        l_pdf = self._numeric_logpdf(cands, centers, bw, bounds)
        if len(rest):
            g_centers, g_bw = self._numeric_kde(rest, bounds)
            g_pdf = self._numeric_logpdf(cands, g_centers, g_bw, bounds)
        else:
            g_pdf = np.zeros_like(l_pdf)
        return p.from_internal(float(cands[np.argmax(l_pdf - g_pdf)]))

    def _suggest_choice(self, p: Param, good: np.ndarray, rest: np.ndarray):
        k = len(p.choices)
        l_counts = np.bincount(good.astype(int), minlength=k) + 1.0
        g_counts = np.bincount(rest.astype(int), minlength=k) + 1.0
        score = np.log(l_counts / l_counts.sum()) - np.log(
            g_counts / g_counts.sum()
        )
        # sample candidates from l, rank by the ratio
        probs = l_counts / l_counts.sum()
        cands = self.rng.choice(k, size=self.n_candidates, p=probs)
        best = cands[np.argmax(score[cands])]
        return p.choices[int(best)]

    def suggest(self, history: List[Tuple[Dict, float]]) -> Dict[str, object]:
        done = [(prm, y) for prm, y in history if y is not None
                and np.isfinite(y)]
        if len(done) < self.n_startup:
            return {p.name: p.sample_uniform(self.rng) for p in self.space}
        ys = np.array([y for _, y in done])
        # hyperopt's gamma schedule: the good set holds only the very best
        # ceil(gamma * sqrt(n)) trials (capped), so l(x) tracks the elite
        # front instead of the full top quantile — a linear-in-n good set
        # measurably over-exploits the first decent cluster
        n_good = min(
            max(1, int(np.ceil(self.gamma * math.sqrt(len(done))))), 25
        )
        order = np.argsort(ys)  # minimize
        good_idx = set(order[:n_good].tolist())
        out = {}
        for p in self.space:
            xs = np.array([p.to_internal(prm[p.name]) for prm, _ in done])
            good = xs[[i in good_idx for i in range(len(done))]]
            rest = xs[[i not in good_idx for i in range(len(done))]]
            if p.kind == "choice":
                out[p.name] = self._suggest_choice(p, good, rest)
            else:
                out[p.name] = self._suggest_numeric(p, good, rest)
        return out


# ---------------------------------------------------------------------------
# sweep driver with persistence
# ---------------------------------------------------------------------------
def run_sweep(
    objective: Callable[[Dict[str, object], int], Optional[float]],
    space: List[Param],
    n_trials: int,
    sampler=None,
    journal: Optional[Path] = None,
    verbose: bool = True,
):
    """Minimize ``objective(params, trial_index)``.

    Persists every finished trial to ``journal`` (JSONL) and resumes from
    it: already-journaled trials count toward ``n_trials`` and seed the
    sampler's history. Returns (best_params, best_value, history).
    """
    sampler = sampler or TPESampler(space)
    history: List[Tuple[Dict, float]] = []
    if journal is not None and Path(journal).exists():
        for line in Path(journal).read_text().splitlines():
            rec = json.loads(line)
            history.append((rec["params"], rec["objective"]))
        if verbose and history:
            print(f"resumed {len(history)} trials from {journal}")

    while len(history) < n_trials:
        trial = len(history)
        params = sampler.suggest(history)
        value = objective(params, trial)
        value = None if value is None else float(value)
        history.append((params, value))
        if journal is not None:
            Path(journal).parent.mkdir(parents=True, exist_ok=True)
            with open(journal, "a") as f:
                f.write(json.dumps({"trial": trial, "params": params,
                                    "objective": value}) + "\n")
        if verbose:
            print(f"[trial {trial}] objective={value} params={params}",
                  flush=True)

    finished = [(p, y) for p, y in history if y is not None
                and np.isfinite(y)]
    if not finished:
        return None, None, history
    best_params, best_value = min(finished, key=lambda r: r[1])
    if verbose:
        print(f"\nbest: objective={best_value} params={best_params}")
    return best_params, best_value, history
