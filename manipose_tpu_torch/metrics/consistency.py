"""Pose-consistency terms of the training loss: bone lengths, their spread
over time (MPSCE) and the smoothness regularizer.

Port of the parts of ``manipose_tpu/metrics/consistency.py`` that
``train.losses.compute_loss`` uses. Layout (..., L, J, 3); variances use
ddof=1 (torch's default, as the reference).
"""

from __future__ import annotations

import torch

from ..geometry.skeleton import Skeleton


def measure_bones_length(joints_coords, skeleton: Skeleton) -> torch.Tensor:
    """(..., L, J, 3) -> (..., L, num_bones) per-frame bone lengths."""
    child = [j for j, _ in skeleton.bones]
    parent = [p for _, p in skeleton.bones]
    diff = joints_coords[..., child, :] - joints_coords[..., parent, :]
    return torch.sqrt(torch.sum(diff**2, dim=-1))


_AGGREGATORS = {"average": torch.mean, "sum": torch.sum, "min": torch.amin,
                "max": torch.amax}


def segments_time_consistency(joints_coords, skeleton: Skeleton,
                              mode: str) -> torch.Tensor:
    """MPSCE: spread of each bone's length over time, aggregated by
    ``mode`` ("std": mean of the standard deviations; "average", "sum",
    "min", "max": of the variances)."""
    lengths = measure_bones_length(joints_coords, skeleton)  # (..., L, S)
    if mode == "std":
        return torch.std(lengths, dim=-2, correction=1).mean()
    aggregator = _AGGREGATORS.get(mode)
    if aggregator is None:
        raise ValueError(
            f"Unexpected value for 'mode': {mode}. "
            "Accepted values are 'average', 'sum', 'std', 'min', 'max'."
        )
    return aggregator(torch.var(lengths, dim=-2, correction=1))


def smoothness_regularization(prediction, weights=None,
                              axis: int = 1) -> torch.Tensor:
    """Mean squared velocity of the prediction, joint-weighted."""
    velocity = torch.diff(prediction, dim=axis)
    if weights is None:
        return (velocity**2).mean()
    if weights.shape[0] != velocity.shape[-2]:
        raise ValueError("one weight per joint")
    return (weights[:, None] * velocity**2).mean()
