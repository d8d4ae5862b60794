"""Skeleton-graph adjacency construction (legacy GCN support).

The port's own copy of ``manipose_tpu/data/graph_utils.py`` (dense numpy,
no JAX). Rebuild of ``hpe/mh_so3_hpe/data/graph_utils.py`` (unused by the main
lifting path there too, kept for capability parity). Dense numpy instead
of scipy.sparse — J=17 graphs don't need sparsity. Semantics match the
reference exactly: duplicate edges accumulate (that is how
``self_weakening`` works — doubling every off-diagonal weight before
normalization shrinks the self weight), symmetrization is the
elementwise max, self-loops are added and the result is ROW-normalized
(D^-1 (A + I), ``graph_utils.py:8-16``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..geometry.skeleton import Skeleton

# extra edges per graph kernel type (``graph_utils.py:62-87``)
_GRAPH_EXTRA_EDGES = {
    "default": [],
    "double_chain": [
        (2, 0), (5, 0), (8, 0), (7, 4), (6, 4), (7, 1), (3, 1), (9, 7),
        (11, 8), (14, 8), (12, 10), (15, 13), (13, 10),
    ],
    "terminal_cycle": [(3, 1), (6, 4), (12, 10), (15, 13)],
    "centralized": [(7, 4), (7, 1), (10, 7), (13, 7)],
    "paired": [(4, 1), (5, 2), (6, 3), (13, 10), (14, 11), (15, 12)],
}


def edges_from_parents(parents: Sequence[int]) -> list:
    return [(j, p) for j, p in enumerate(parents) if p >= 0]


def adj_mx_from_edges(
    num_pts: int, edges: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Dense equivalent of ``graph_utils.py:29-50`` (sparse=False):
    accumulate duplicate edges, max-symmetrize, add self-loops,
    row-normalize."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    adj = np.zeros((num_pts, num_pts), np.float32)
    np.add.at(adj, (edges[:, 0], edges[:, 1]), 1.0)
    # adj + adj.T*(adj.T>adj) - adj*(adj.T>adj) == elementwise max
    adj = np.maximum(adj, adj.T)
    adj = adj + np.eye(num_pts, dtype=np.float32)
    rowsum = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        r_inv = 1.0 / rowsum
    r_inv[~np.isfinite(r_inv)] = 0.0
    return r_inv[:, None] * adj


def adj_mx_from_skeleton(
    skeleton: Skeleton,
    graph_type: str = "default",
    refine_type: str = "default",
) -> np.ndarray:
    """Normalized adjacency from a skeleton (``graph_utils.py:53-100``)."""
    edges = edges_from_parents(skeleton.parents)
    if graph_type not in _GRAPH_EXTRA_EDGES:
        raise ValueError(f"Invalid graph kernel type: {graph_type}")
    edges = edges + _GRAPH_EXTRA_EDGES[graph_type]
    if refine_type == "default":
        pass
    elif refine_type == "self_weakening":
        edges = edges + list(edges)
    elif refine_type == "self_reinforcement":
        edges = edges + [(n, n) for n in range(skeleton.num_joints)]
    else:
        raise ValueError(f"Invalid refinement type: {refine_type}")
    return adj_mx_from_edges(skeleton.num_joints, edges)
