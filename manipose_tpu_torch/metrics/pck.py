"""3DPCK and 3DAUC with none, scale or Procrustes alignment.

Port of ``manipose_tpu/metrics/pck.py``: the Procrustes alignment of every
sample is one batched ``torch.linalg.svd``, with the determinant-sign fix
(the Z matrix) for reflections.
"""

from __future__ import annotations

from typing import Optional

import torch

from .joint_errors import _det3


def compute_similarity_transform(source_points: torch.Tensor,
                                 target_points: torch.Tensor) -> torch.Tensor:
    """Orthogonal-Procrustes alignment (rotation, scale, translation) of
    each source onto its target. (..., N, 3) -> (..., N, 3)."""
    src = source_points.transpose(-1, -2)  # (..., 3, N)
    tgt = target_points.transpose(-1, -2)

    mu1 = src.mean(dim=-1, keepdim=True)
    mu2 = tgt.mean(dim=-1, keepdim=True)
    x1 = src - mu1
    x2 = tgt - mu2
    var1 = torch.sum(x1**2, dim=(-1, -2), keepdim=True)

    k = x1 @ x2.transpose(-1, -2)  # (..., 3, 3)
    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)

    det = _det3(u @ v.transpose(-1, -2))
    z = torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape).clone()
    z[..., -1, -1] = z[..., -1, -1] * torch.sign(det)
    r = v @ (z @ u.transpose(-1, -2))

    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1)[..., None, None] / var1
    t = mu2 - scale * (r @ mu1)
    return (scale * (r @ src) + t).transpose(-1, -2)


def _align(pred, gt, alignment: str):
    if alignment == "none":
        return pred
    if alignment == "procrustes":
        return compute_similarity_transform(pred, gt)
    if alignment == "scale":
        pred_dot_pred = torch.einsum("nkc,nkc->n", pred, pred)
        pred_dot_gt = torch.einsum("nkc,nkc->n", pred, gt)
        return pred * (pred_dot_gt / pred_dot_pred)[:, None, None]
    raise ValueError(f"Invalid value for alignment: {alignment}")


def _handle_mask(mask, gt):
    if mask is None:
        return torch.ones(gt.shape[:-1], dtype=torch.bool, device=gt.device)
    return mask.to(torch.bool)


def keypoint_3d_pck(pred, gt, mask: Optional[torch.Tensor] = None,
                    alignment: str = "none", threshold: float = 150.0):
    """Percentage of correct keypoints at ``threshold`` (mm). pred, gt:
    (N, K, 3); mask: (N, K) visibility."""
    mask = _handle_mask(mask, gt)
    pred = _align(pred, gt, alignment)
    error = torch.linalg.vector_norm(pred - gt, dim=-1)
    correct = (error < threshold).to(torch.float32)
    return torch.sum(correct * mask) / torch.sum(mask) * 100.0


def keypoint_3d_auc(pred, gt, mask: Optional[torch.Tensor] = None,
                    alignment: str = "none"):
    """Area under the PCK curve over 31 thresholds in [0, 150] mm."""
    mask = _handle_mask(mask, gt)
    pred = _align(pred, gt, alignment)
    error = torch.linalg.vector_norm(pred - gt, dim=-1)
    thresholds = torch.linspace(0.0, 150.0, 31, device=error.device)
    correct = (error[None] < thresholds[:, None, None]).to(torch.float32)
    pck_values = torch.sum(correct * mask[None], dim=(1, 2)) / torch.sum(mask)
    return torch.mean(pck_values) * 100.0
