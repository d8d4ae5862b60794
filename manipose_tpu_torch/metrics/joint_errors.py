"""Evaluation joint-error metrics, with Procrustes-aligned P-MPJPE.

Port of ``manipose_tpu/metrics/joint_errors.py``. The "flat" metrics take
any (..., J, 3); the segment-length error takes (B, L, J, 3). P-MPJPE is
one batched ``torch.linalg.svd`` of the 3 x 3 cross-covariances on the
tensors' device, with the determinant-sign fix for reflections.
"""

from __future__ import annotations

import torch

from ..geometry.skeleton import Skeleton
from .consistency import measure_bones_length

_AGGREGATORS = {
    "average": torch.mean,
    "sum": torch.sum,
    "no_agg": lambda x, dim=None: x,
}


def _agg(mode: str):
    if mode not in _AGGREGATORS:
        raise ValueError(
            f"Unexpected value for 'mode': {mode}. "
            "Accepted values are 'average', 'sum' and 'no_agg'."
        )
    return _AGGREGATORS[mode]


def mpjpe_error(batch_imp, batch_gt, mode: str):
    """Euclidean error per joint sample."""
    a = batch_imp.reshape(-1, 3)
    b = batch_gt.reshape(-1, 3)
    return _agg(mode)(torch.linalg.vector_norm(b - a, dim=1))


def mse_error(batch_imp, batch_gt, mode: str):
    a = batch_imp.reshape(-1, 3)
    b = batch_gt.reshape(-1, 3)
    return _agg(mode)(torch.sum((b - a) ** 2, dim=1))


def jointwise_error(batch_imp, batch_gt, mode: str):
    j = batch_gt.shape[-2]
    a = batch_imp.reshape(-1, j, 3)
    b = batch_gt.reshape(-1, j, 3)
    return _agg(mode)(torch.linalg.vector_norm(b - a, dim=2), dim=0)


def jointwise_mse(batch_imp, batch_gt, mode: str):
    j = batch_gt.shape[-2]
    a = batch_imp.reshape(-1, j, 3)
    b = batch_gt.reshape(-1, j, 3)
    return _agg(mode)(torch.sum((b - a) ** 2, dim=2), dim=0)


def coordwise_error(batch_imp, batch_gt, mode: str):
    a = batch_imp.reshape(-1, 3)
    b = batch_gt.reshape(-1, 3)
    return _agg(mode)(torch.abs(b - a), dim=0)


def segments_len_err(batch_imp, batch_gt, skeleton: Skeleton, mode: str,
                     signed: bool = True):
    """Bone-length error between prediction and ground truth, per bone
    sample."""
    pred_len = measure_bones_length(batch_imp, skeleton).reshape(-1, skeleton.num_bones)
    gt_len = measure_bones_length(batch_gt, skeleton).reshape(-1, skeleton.num_bones)
    diff = gt_len - pred_len
    if not signed:
        diff = torch.abs(diff)
    return _agg(mode)(diff)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3), as the JAX package takes it."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def p_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after rigid alignment (Procrustes, "Protocol #2") of each pose
    onto its target. Accepts (..., J, 3).

    The rotation R = V U^T of the SVD H = U S V^T does not depend on the
    signs a library picks for paired singular vectors; where det R < 0
    (a reflection) the last column of V and the last singular value flip
    sign, as in the reference."""
    if predicted.shape != target.shape or predicted.shape[-1] != 3:
        raise ValueError("p_mpjpe takes two (..., J, 3) tensors of one shape")
    j = predicted.shape[-2]
    predicted = predicted.reshape(-1, j, 3)
    target = target.reshape(-1, j, 3)

    mu_x = target.mean(dim=1, keepdim=True)
    mu_y = predicted.mean(dim=1, keepdim=True)
    x0 = target - mu_x
    y0 = predicted - mu_y
    norm_x = torch.sqrt(torch.sum(x0**2, dim=(1, 2), keepdim=True))
    norm_y = torch.sqrt(torch.sum(y0**2, dim=(1, 2), keepdim=True))
    x0 = x0 / norm_x
    y0 = y0 / norm_y

    h = x0.transpose(1, 2) @ y0  # (N, 3, 3)
    u, s, vt = torch.linalg.svd(h)
    v = vt.transpose(1, 2)
    r = v @ u.transpose(1, 2)

    sign_det = torch.sign(_det3(r))  # (N,)
    flip = torch.ones_like(s)
    flip[:, -1] = sign_det
    v = v * flip[:, None, :]
    s = s * flip
    r = v @ u.transpose(1, 2)

    tr = torch.sum(s, dim=1, keepdim=True)[..., None]
    a = tr * norm_x / norm_y
    t = mu_x - a * (mu_y @ r)
    predicted_aligned = a * (predicted @ r) + t
    return torch.mean(torch.linalg.vector_norm(predicted_aligned - target, dim=-1))
