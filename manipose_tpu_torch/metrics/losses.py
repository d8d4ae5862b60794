"""Training losses: weighted MPJPE/MSE, velocity, WTA/MCL and the scoring
BCE.

Port of ``manipose_tpu/metrics/losses.py``. Pose layout (..., L, J, C);
hypotheses (B, H, L, J, 3); scores (B, H, L, 1).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

# Joint weights of the MixSTE lineage (the JAX package's
# ``STANDARD_H36M_WEIGHTS``), one per H36M joint.
STANDARD_H36M_WEIGHTS = (1, 1, 2.5, 2.5, 1, 2.5, 2.5, 1, 1, 1, 1.5, 1.5, 4, 4,
                         1.5, 4, 4)
# The same for the 15-joint HumanEva skeleton (``STANDARD_HEVA_WEIGHTS``).
STANDARD_HEVA_WEIGHTS = (1, 1, 2.5, 2.5, 1, 2.5, 2.5, 1, 1.5, 1.5, 4, 4, 1.5, 4, 4)


@functools.lru_cache(maxsize=None)
def _weights_on(device: torch.device) -> torch.Tensor:
    # made outside inference mode, so that autograd may save it later
    with torch.inference_mode(False):
        return torch.tensor(STANDARD_H36M_WEIGHTS, dtype=torch.float32, device=device)


def h36m_weights(like: torch.Tensor) -> torch.Tensor:
    """:data:`STANDARD_H36M_WEIGHTS` in fp32 on ``like``'s device, copied
    to the device once and cached, so a train step does not wait on it.
    fp32 like the JAX package's numpy table, so a bf16 error term that
    they weight is promoted to fp32 there as here."""
    return _weights_on(like.device)


def _sequential_mean(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Means over ``dims`` one at a time, in order (the axes shift as in
    the reference's sequential ``mean(dim=d)``)."""
    for d in dims:
        x = x.mean(dim=d)
    return x


def weighted_mpjpe_loss(prediction, target, weights=None,
                        dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Joint-weighted mean Euclidean error."""
    err = torch.linalg.vector_norm(prediction - target, dim=-1)
    if weights is not None:
        if weights.shape[0] != target.shape[-2]:
            raise ValueError("one weight per joint")
        err = weights * err
    if dims is None:
        return err.mean()
    return _sequential_mean(err, dims)


def weighted_mse_loss(prediction, target, weights=None,
                      dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Joint-weighted squared error; a plain MSE without weights."""
    if weights is None:
        return ((prediction - target) ** 2).mean()
    if weights.shape[0] != target.shape[-2]:
        raise ValueError("one weight per joint")
    err = weights[:, None] * (prediction - target) ** 2
    if dims is None:
        return err.mean()
    return _sequential_mean(err, dims)


def n_mpjpe(prediction, target) -> torch.Tensor:
    """MotionBERT's scale-normalised MPJPE (``n_mpjpe`` of its
    ``lib/model/loss.py``): in each (row, frame) the prediction is scaled by
    the least-squares scale onto the target, mean_j <t, p> / mean_j |p|^2,
    which is not detached, so the gradient flows through it; then the plain
    MPJPE. Poses (B, L, J, 3)."""
    norm_pred = torch.mean(torch.sum(prediction**2, dim=-1, keepdim=True), dim=-2, keepdim=True)
    norm_tgt = torch.mean(torch.sum(target * prediction, dim=-1, keepdim=True), dim=-2,
                          keepdim=True)
    return weighted_mpjpe_loss(norm_tgt / norm_pred * prediction, target)


def mean_velocity_error(predicted, target, axis: int = 1,
                        squared: bool = False) -> torch.Tensor:
    """Mean per-joint velocity error; a target without the hypothesis axis
    is broadcast over it."""
    if predicted.dim() > target.dim():
        target = target.unsqueeze(1).expand_as(predicted)
    elif predicted.shape != target.shape:
        raise ValueError("predicted and target shapes differ")
    diff = torch.diff(predicted, dim=axis) - torch.diff(target, dim=axis)
    if squared:
        return (diff**2).mean()
    return torch.linalg.vector_norm(diff, dim=-1).mean()


def _l2_loss_per_hyp(hypothesis, y, weights=None,
                     squared: bool = False) -> torch.Tensor:
    """Per-hypothesis L2 loss: (B, H, L, J, 3) vs (B, L, J, 3) -> (B, H, L)."""
    target = y.unsqueeze(1).expand_as(hypothesis)
    if squared:
        return weighted_mse_loss(hypothesis, target, weights, dims=[4, 3])
    return weighted_mpjpe_loss(hypothesis, target, weights, dims=[3])


def wta_l2_loss_and_activate_head(
    hypothesis, y, weights=None, squared: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-takes-all loss and the winning head per (B, L): the minimum
    over hypotheses and its first index on ties. ``amin`` shares the
    gradient among tied minima, as ``jnp.min`` does."""
    base = _l2_loss_per_hyp(hypothesis, y, weights, squared)  # (B, H, L)
    return torch.amin(base, dim=1), torch.argmin(base, dim=1)


def binary_cross_entropy(probs, targets) -> torch.Tensor:
    """Elementwise-mean BCE on probabilities with the log clamped at -100,
    written out: ``F.binary_cross_entropy`` clamps a denominator in its
    backward instead, so its gradient differs where a score saturates."""
    log_p = torch.clamp(torch.log(probs), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-probs), min=-100.0)
    return (-(targets * log_p + (1.0 - targets) * log_1p)).mean()


def one_hot_winners(active_idx, n_hyp: int, dtype) -> torch.Tensor:
    """(B, L) winning heads -> (B, H, L) one-hot score targets."""
    heads = torch.arange(n_hyp, device=active_idx.device)
    return (active_idx[:, None, :] == heads[None, :, None]).to(dtype)


def wta_with_scoring_loss(hypothesis, scores, y, beta: float, weights=None,
                          squared: bool = False):
    """WTA loss plus the BCE of the plausibility scores against one-hot
    winners. hypothesis (B, H, L, J, 3), scores (B, H, L, 1), y (B, L, J, 3).

    With ``beta == 0`` returns only the scalar WTA loss (the reference's
    behaviour); otherwise ``(total, beta * scoring_loss)``."""
    unagg_wta, active_idx = wta_l2_loss_and_activate_head(
        hypothesis, y, weights=weights, squared=squared)
    if beta == 0:
        return unagg_wta.mean()
    gt_scores = one_hot_winners(active_idx, hypothesis.shape[1], scores.dtype)
    scoring_loss = binary_cross_entropy(scores[..., 0], gt_scores)
    return unagg_wta.mean() + beta * scoring_loss, beta * scoring_loss
