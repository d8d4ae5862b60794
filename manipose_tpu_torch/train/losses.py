"""Composite training loss.

Port of ``manipose_tpu/train/losses.py``: one function returning the
scalar total and a dict of per-term values for logging.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..geometry.skeleton import Skeleton
from ..metrics.consistency import (
    segments_time_consistency,
    smoothness_regularization,
)
from ..metrics.losses import (
    binary_cross_entropy,
    h36m_weights,
    mean_velocity_error,
    one_hot_winners,
    weighted_mpjpe_loss,
    weighted_mse_loss,
    wta_l2_loss_and_activate_head,
)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The ``train`` config group's loss knobs (``configs/config.yaml``)."""

    sq_loss: bool = False
    w_loss: bool = True
    vel_loss: float = 2.0
    smooth_reg: float = 0.5
    rmcl_score_reg: float = 0.1
    rigid_seg_reg: float = 0.0
    rmcl: bool = True  # the model emits (hypotheses, scores)


def compute_loss(
    prediction,
    target: torch.Tensor,
    cfg: LossConfig,
    skeleton: Optional[Skeleton] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total loss, per-term dict).

    ``prediction`` is (B, L, J, 3) for single-hypothesis models, or the
    tuple (poses (B, H, L, J, 3), scores (B, H, L, 1)) for rMCL. Terms:
    - wloss: weighted MPJPE/MSE, or its WTA form over hypotheses;
    - score_reg: beta-weighted BCE on the scores against the WTA winners
      (rMCL only);
    - vloss: velocity error (time axis 2 for rMCL, 1 otherwise);
    - sreg: smoothness regularization of the prediction;
    - rigid_seg_reg: the segment-length consistency penalty.
    """
    terms: Dict[str, torch.Tensor] = {}
    if cfg.rmcl:
        poses, scores = prediction
        time_axis = 2
    else:
        poses = prediction
        time_axis = 1
    weights = h36m_weights(poses) if cfg.w_loss else None

    if cfg.rmcl:
        unagg_wta, active_idx = wta_l2_loss_and_activate_head(
            poses, target, weights=weights, squared=cfg.sq_loss
        )
        terms["wloss"] = unagg_wta.mean()
        if cfg.rmcl_score_reg > 0:
            gt_scores = one_hot_winners(active_idx, poses.shape[1], scores.dtype)
            terms["score_reg"] = cfg.rmcl_score_reg * binary_cross_entropy(
                scores[..., 0], gt_scores
            )
    else:
        loss_fn = weighted_mse_loss if cfg.sq_loss else weighted_mpjpe_loss
        terms["wloss"] = loss_fn(poses, target, weights=weights)

    if cfg.vel_loss > 0:
        terms["vloss"] = cfg.vel_loss * mean_velocity_error(
            poses, target, axis=time_axis, squared=cfg.sq_loss
        )
    if cfg.smooth_reg > 0:
        terms["sreg"] = cfg.smooth_reg * smoothness_regularization(
            poses, weights=weights, axis=time_axis
        )
    if cfg.rigid_seg_reg > 0:
        if skeleton is None:
            raise ValueError("rigid_seg_reg needs the skeleton")
        terms["rigid_seg_reg"] = cfg.rigid_seg_reg * segments_time_consistency(
            poses, skeleton=skeleton, mode="sum"
        )

    total = sum(terms.values())
    return total, terms
