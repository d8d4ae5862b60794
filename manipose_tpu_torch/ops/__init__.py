"""Kernels of the port and their dispatch.

K1 and K3 (``cuda_attention``) and K5 (``cuda_mlp``), and their backward
kernels K2, K4 and K6, are hand-written CUDA C++ kernels for Hopper
(``csrc/``), built by ``build`` at first use. Each wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor, and counts its launches by operand dtype; the autograd Functions
pair each forward kernel with its backward.

A CUDA graph (the train megastep, ``train/step.py``) records launches once,
at its capture, where the wrappers count them; each replay launches them
again without the wrappers. :func:`record_replay` counts a replay and adds
its capture's launches to a second count (:func:`replayed_counts`), so the
launches of a graph's calls are its capture's times its replays.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cuda_attention, cuda_mlp


def launch_counts(dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel: all of them, or
    only those on ``dtype`` operands (fp32 or bf16)."""
    return _by_dtype({**cuda_attention.LAUNCHES, **cuda_mlp.LAUNCHES}, dtype)


# graph replays counted by record_replay since the last reset
GRAPH_REPLAYS = {"replays": 0}


def _by_dtype(counts, dtype):
    return {name: sum(by_dtype.values()) if dtype is None else by_dtype[dtype]
            for name, by_dtype in counts.items()}


def launch_snapshot() -> Dict[str, Dict[torch.dtype, int]]:
    """A copy of the wrappers' counts by kernel and operand dtype."""
    return {name: dict(by_dtype) for module in (cuda_attention, cuda_mlp)
            for name, by_dtype in module.LAUNCHES.items()}


def launches_since(snapshot) -> Dict[str, Dict[torch.dtype, int]]:
    """The wrappers' launches by kernel and dtype since ``snapshot``."""
    now = launch_snapshot()
    return {name: {dt: n - snapshot[name][dt] for dt, n in by_dtype.items()}
            for name, by_dtype in now.items()}


def record_replay(captured) -> None:
    """Count one replay of a graph whose capture made the launches
    ``captured`` (``launches_since`` around the capture)."""
    GRAPH_REPLAYS["replays"] += 1
    for module in (cuda_attention, cuda_mlp):
        for name, by_dtype in module.REPLAYED.items():
            for dt in by_dtype:
                by_dtype[dt] += captured.get(name, {}).get(dt, 0)


def replayed_counts(dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Launches made by graph replays since the last reset, by kernel (all
    of them, or those on ``dtype`` operands)."""
    return _by_dtype({**cuda_attention.REPLAYED, **cuda_mlp.REPLAYED}, dtype)


def reset_launch_counts() -> None:
    GRAPH_REPLAYS["replays"] = 0
    for counts in (cuda_attention.LAUNCHES, cuda_mlp.LAUNCHES,
                   cuda_attention.REPLAYED, cuda_mlp.REPLAYED):
        for by_dtype in counts.values():
            for dtype in by_dtype:
                by_dtype[dtype] = 0
