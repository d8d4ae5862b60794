"""Toy-experiment metrics (``toy_experiment/training/metrics.py``).

The port's own copy of ``manipose_tpu/toy/metrics.py`` (numpy only): they
score the predictions after they come back to the host."""

from __future__ import annotations

import numpy as np


def calc_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """(B, 2) circle-point error (``metrics.py:5-9``)."""
    return float(np.linalg.norm(pred - gt, axis=1).mean())


def oracle_multihyp_mpjpe(hypothesis: np.ndarray, gt: np.ndarray) -> float:
    """min-over-hypotheses error (``metrics.py:12-23``)."""
    preds = hypothesis[..., :2]
    err = np.linalg.norm(preds - gt[:, None], axis=2)  # (B, H)
    return float(err.min(axis=1).mean())


def distance_to_circle(pred: np.ndarray) -> float:
    """1 - mean radius of predictions (``metrics.py:26-29``)."""
    return float(1 - np.linalg.norm(pred, axis=1).mean())


def torus_points_to_joints_np(points, major_radius=2.0, minor_radius=1.0):
    """(..., 3) -> (joint1 (..., 3), joint2 (..., 3))
    (``metrics.py:81-109``)."""
    norm_xy = np.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2)[..., None]
    joint1 = major_radius * points[..., :2] / norm_xy
    joint1 = np.concatenate(
        [joint1, np.zeros(points.shape[:-1] + (1,))], axis=-1
    )
    return joint1, points


def calc_mpjpe_3d(
    pred: np.ndarray,
    gt: np.ndarray,
    joints_predictions: bool = False,
    major_radius: float = 2.0,
    minor_radius: float = 1.0,
) -> float:
    """Mean of the two joint errors after the torus->joints map
    (``metrics.py:32-46``). pred: (B, 6) if joints_predictions else (B, 3)."""
    gt1, gt2 = torus_points_to_joints_np(gt, major_radius, minor_radius)
    if joints_predictions:
        p1, p2 = pred[:, :3], pred[:, 3:]
    else:
        p1, p2 = torus_points_to_joints_np(pred, major_radius, minor_radius)
    return 0.5 * (
        float(np.linalg.norm(p1 - gt1, axis=1).mean())
        + float(np.linalg.norm(p2 - gt2, axis=1).mean())
    )


def std_length(
    pred: np.ndarray,
    joint_prediction: bool = False,
    mcl_version: bool = False,
    major_radius: float = 2.0,
    minor_radius: float = 1.0,
) -> float:
    """Consistency metric: std of the two segment lengths
    (``metrics.py:120-138``)."""
    if joint_prediction:
        p1, p2 = pred[:, :3], pred[:, 3:]
    elif mcl_version:
        p1, p2 = torus_points_to_joints_np(
            pred[:, :, :-1], major_radius, minor_radius
        )  # (B, H, 3) each
        h = p1.shape[1]
        d1 = np.stack(
            [np.linalg.norm(p1[:, i], axis=1) for i in range(h)]
        )
        d2 = np.stack(
            [np.linalg.norm(p2[:, i] - p1[:, i], axis=1) for i in range(h)]
        )
        return float((d1.std() + d2.std()) / 2)
    else:
        p1, p2 = torus_points_to_joints_np(pred, major_radius, minor_radius)
    d1 = np.linalg.norm(p1, axis=1)
    d2 = np.linalg.norm(p2 - p1, axis=1)
    return float((d1.std() + d2.std()) / 2)
