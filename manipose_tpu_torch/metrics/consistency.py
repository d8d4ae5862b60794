"""Pose-consistency metrics: bone lengths, their spread over time (MPSCE),
their stretch, sagittal symmetry (MPSSE) and the smoothness regularizer.

Port of ``manipose_tpu/metrics/consistency.py``. Layout (..., L, J, 3);
variances use ddof=1 (torch's default, as the reference).
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


def _time_stat(joints_coords, skeleton: Skeleton, mode: str):
    """Each bone's standard deviation (``mode="std"``, aggregated by the
    mean) or variance over time, and the aggregator of ``mode``."""
    lengths = measure_bones_length(joints_coords, skeleton)  # (..., L, S)
    if mode == "std":
        return torch.std(lengths, dim=-2, correction=1), torch.mean
    aggregator = _AGGREGATORS.get(mode)
    if aggregator is None:
        raise ValueError(
            f"Unexpected value for 'mode': {mode}. "
            "Accepted values are 'average', 'sum', 'std', 'min', 'max'."
        )
    return torch.var(lengths, dim=-2, correction=1), aggregator


def segments_time_consistency(joints_coords, skeleton: Skeleton,
                              mode: str) -> torch.Tensor:
    """MPSCE: spread of each bone's length over time, aggregated by
    ``mode`` ("std": mean of the standard deviations; "average", "sum",
    "min", "max": of the variances)."""
    stat, aggregator = _time_stat(joints_coords, skeleton, mode)
    return aggregator(stat)


def segments_time_consistency_per_bone(joints_coords, skeleton: Skeleton,
                                       mode: str) -> torch.Tensor:
    """Per-bone MPSCE: input (B, L, J, 3), aggregated over the batch axis."""
    stat, aggregator = _time_stat(joints_coords, skeleton, mode)
    return aggregator(stat, dim=0)


def segments_max_stretch_per_bone(joints_coords, skeleton: Skeleton):
    """(min, max) of each bone's length over all frames and batches."""
    lengths = measure_bones_length(joints_coords, skeleton).reshape(
        -1, skeleton.num_bones)
    return torch.amin(lengths, dim=0), torch.amax(lengths, dim=0)


def segments_max_diff_stretch_per_bone(joints_coords, skeleton: Skeleton):
    """Each bone's largest frame-to-frame length jump, and where it is
    (the first index of the maximum)."""
    lengths = measure_bones_length(joints_coords, skeleton)  # (..., L, S)
    diffs = torch.abs(torch.diff(lengths, dim=-2)).reshape(-1, skeleton.num_bones)
    return torch.amax(diffs, dim=0), torch.argmax(diffs, dim=0)


def _symmetry(joints_coords, skeleton: Skeleton, squared: bool) -> torch.Tensor:
    lengths = measure_bones_length(joints_coords, skeleton)  # (..., L, S)
    diff = torch.abs(lengths[..., list(skeleton.bones_left)]
                     - lengths[..., list(skeleton.bones_right)])
    return diff**2.0 if squared else diff


_SYMMETRY_AGGREGATORS = {"average": torch.mean, "sum": torch.sum}


def _symmetry_aggregator(mode: str):
    aggregator = _SYMMETRY_AGGREGATORS.get(mode)
    if aggregator is None:
        raise ValueError(
            f"Unexpected value for 'mode': {mode}. "
            "Accepted values are 'average' and 'sum'."
        )
    return aggregator


def sagittal_symmetry(joints_coords, skeleton: Skeleton, mode: str,
                      squared: bool = True) -> torch.Tensor:
    """MPSSE: left/right bone-length asymmetry. Input (..., L, J, 3)."""
    return _symmetry_aggregator(mode)(_symmetry(joints_coords, skeleton, squared))


def sagittal_symmetry_per_bone(joints_coords, skeleton: Skeleton, mode: str,
                               squared: bool = True) -> torch.Tensor:
    """Per-bone MPSSE over the flattened batch and time axes."""
    diff = _symmetry(joints_coords, skeleton, squared)
    return _symmetry_aggregator(mode)(
        diff.reshape(-1, len(skeleton.bones_left)), dim=0)


def smoothness_regularization(prediction, weights=None,
                              axis: int = 1) -> torch.Tensor:
    """Mean squared velocity of the prediction, joint-weighted."""
    velocity = torch.diff(prediction, dim=axis)
    if weights is None:
        return (velocity**2).mean()
    if weights.shape[0] != velocity.shape[-2]:
        raise ValueError("one weight per joint")
    return (weights[:, None] * velocity**2).mean()
