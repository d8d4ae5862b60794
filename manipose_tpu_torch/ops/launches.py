"""The launch ledger: which kernel ran, on which path, on which operands.

Every wrapper of ``ops`` counts each launch with one call,
:func:`count` (kernel, path, dtype), made by the function that launches,
so a launch counts once however it was chosen. The kernel is the
wrapper's name (``fused_mlp``); the path names the device kernels that
ran it: ``wgmma`` or ``mma.sync`` for K5/K6, ``mma.sync`` for K1-K4 and
``simt`` for the stream fusion. :data:`KERNELS` is the inventory: each
wrapper module registers its kernels, the library they are built in and,
per path, the device kernels (as compiled) that a launch on it runs.

A CUDA graph (the train megastep) records launches once, at its capture,
where the wrappers count them; each replay launches them again without
the wrappers. :func:`record_replay` counts a replay and adds its capture's
launches (:func:`launches_since` a snapshot taken before the capture) to a
second count, so the launches of a graph's calls are its capture's times
its replays.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

import torch

Key = Tuple[str, str, torch.dtype]  # (kernel, path, operand dtype)

# kernel -> {"library": build's library name, "paths": {path: device kernels}}
KERNELS: Dict[str, dict] = {}
# launches since the last reset, and those made by graph replays, by key
_launched: Counter = Counter()
_replayed: Counter = Counter()
_graph_replays = 0


def register(library: str, kernels: Dict[str, Dict[str, Tuple[str, ...]]]) -> None:
    """Add a wrapper module's kernels to the inventory: {kernel: {path:
    device kernels}}, all built in ``library``."""
    for kernel, paths in kernels.items():
        KERNELS[kernel] = {"library": library, "paths": paths}


def count(kernel: str, path: str, dtype: torch.dtype) -> None:
    """One launch of ``kernel`` on ``path`` with ``dtype`` operands."""
    _launched[kernel, path, dtype] += 1


def by_kernel(counts: Dict[Key, int], dtype: Optional[torch.dtype] = None,
              path: Optional[str] = None) -> Dict[str, int]:
    """{kernel: n} of ledger-keyed ``counts`` (all of them, or those on
    ``dtype`` operands and ``path``) for every kernel of the inventory and
    of ``counts``."""
    out = dict.fromkeys(KERNELS, 0)
    for (kernel, p, dt), n in counts.items():
        out[kernel] = out.get(kernel, 0) + (n if dtype in (None, dt) and path in (None, p)
                                            else 0)
    return out


def launch_counts(dtype: Optional[torch.dtype] = None,
                  path: Optional[str] = None) -> Dict[str, int]:
    """Launches since the last reset, by kernel."""
    return by_kernel(_launched, dtype, path)


def replayed_counts(dtype: Optional[torch.dtype] = None,
                    path: Optional[str] = None) -> Dict[str, int]:
    """Launches made by graph replays since the last reset, by kernel."""
    return by_kernel(_replayed, dtype, path)


def graph_replays() -> int:
    """Graph replays counted by :func:`record_replay` since the last reset."""
    return _graph_replays


def launch_snapshot() -> Dict[Key, int]:
    """A copy of the launches by (kernel, path, dtype)."""
    return dict(_launched)


def launches_since(snapshot: Dict[Key, int]) -> Dict[Key, int]:
    """The launches by (kernel, path, dtype) since ``snapshot``."""
    return {key: n - snapshot.get(key, 0) for key, n in _launched.items()
            if n != snapshot.get(key, 0)}


def record_replay(captured: Dict[Key, int]) -> None:
    """Count one replay of a graph whose capture made the launches
    ``captured`` (:func:`launches_since` around the capture)."""
    global _graph_replays
    _graph_replays += 1
    _replayed.update(captured)


def reset_launch_counts() -> None:
    global _graph_replays
    _launched.clear()
    _replayed.clear()
    _graph_replays = 0
