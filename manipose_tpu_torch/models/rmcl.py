"""rMCL multi-hypothesis manifold model: K scored hypotheses.

Port of ``manipose_tpu/models/rmcl.py``. Parameters are stored per head
under the reference names (``head.{h}.norm``, ``head.{h}.prediction_head``,
``head.{h}.score_head``); the forward pass stacks them and applies all K
heads with one product each, folding each head's LayerNorm affine into its
projection as the JAX package does.

Under bf16 compute the heads normalize the bf16 trunk features in bf16,
then multiply by the fp32 folded kernel, which promotes: hypotheses,
logits and scores come out fp32, as in the JAX package (where ``x_hat``
is bf16 and the kernel fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..geometry.skeleton import Skeleton
from ..metrics.losses import wta_l2_loss_and_activate_head
from .decoder import decode_poses
from .manifold import BonesMixSTE, ManifoldConfig
from .mix_ste import MixSTE


class MCLHead(nn.Module):
    """One head: LayerNorm (eps 1e-5) -> Linear(C -> out+1); the last
    channel per joint feeds a Linear(J -> 1) score head."""

    def __init__(self, embed_dim: int, out_dim: int, num_joints: int):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.prediction_head = nn.Linear(embed_dim, out_dim + 1)
        self.score_head = nn.Linear(num_joints, 1)


class MCLHeads(nn.ModuleList):
    """K MCL heads applied together.

    (B, L, J, C) -> (preds (B, H, L, J, out), logits (B, H, L, 1)).
    """

    def __init__(self, n_hyp: int, embed_dim: int, out_dim: int,
                 num_joints: int, readout_div: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            MCLHead(embed_dim, out_dim, num_joints) for _ in range(n_hyp)
        )
        self.readout_div = readout_div
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ln_scale = torch.stack([h.norm.weight for h in self])  # (H, C)
        ln_bias = torch.stack([h.norm.bias for h in self])
        pred_w = torch.stack([h.prediction_head.weight for h in self])  # (H, D, C)
        pred_b = torch.stack([h.prediction_head.bias for h in self])  # (H, D)
        score_w = torch.stack([h.score_head.weight[0] for h in self])  # (H, J)
        score_b = torch.stack([h.score_head.bias for h in self])  # (H, 1)
        # LN statistics are head-independent: (x_hat*s + b) W^T
        # = x_hat (s*W)^T + b W^T; MuReadout divides its whole input.
        # x_hat is in the compute dtype, the folded kernel fp32: the
        # products promote to fp32
        x_hat = nn.functional.layer_norm(x.to(self.dtype), x.shape[-1:], eps=1e-5)
        x_hat = (x_hat / self.readout_div).to(pred_w.dtype)
        kernel = ln_scale[:, :, None] * pred_w.transpose(1, 2)  # (H, C, D)
        bias = torch.einsum("hc,hdc->hd", ln_bias / self.readout_div, pred_w)
        bias = bias + pred_b
        out = torch.einsum("bljc,hcd->bhljd", x_hat, kernel)
        out = out + bias[None, :, None, None, :]  # (B, H, L, J, out+1)
        preds = out[..., :-1]
        logits = torch.einsum("bhlj,hj->bhl", out[..., -1], score_w)
        logits = logits[..., None] + score_b[None, :, None, :]
        return preds, logits


class RMCLRotMixSTE(MixSTE):
    """MixSTE trunk + K MCL heads, scores softmaxed across hypotheses.

    Reference quirk kept: ``mup`` never reaches this trunk (head_dim**-0.5
    attention, unit residual scale); only the MCL heads are MuReadouts."""

    def __init__(self, cfg: ManifoldConfig):
        trunk = dataclasses.replace(cfg.rot_trunk_config(), mup=False)
        super().__init__(trunk, apply_head=False)
        self.head = MCLHeads(
            cfg.n_hyp, cfg.embed_dim_rot, cfg.rot_rep_dim, cfg.num_joints,
            (cfg.embed_dim_rot / cfg.mup_base_width) if cfg.mup else 1.0,
            cfg.dtype,
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        preds, logits = self.head(self.trunk(x))
        return preds, torch.softmax(logits, dim=1)


class RMCLManifoldMixSTE(nn.Module):
    """Multi-hypothesis manifold model.

    (B, L, J, 2) -> (poses (B, H, L, J, 3), scores (B, H, L, 1)); all
    hypotheses share the segments branch's bone lengths.
    """

    def __init__(self, cfg: ManifoldConfig, skeleton: Skeleton):
        super().__init__()
        self.cfg = cfg
        self.skeleton = skeleton
        self.rotations_module = RMCLRotMixSTE(cfg)
        self.segments_module = BonesMixSTE(cfg)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rotations, scores = self.rotations_module(x)
        lengths = self.segments_module(x)[:, None, None, :, 0]  # (B, 1, 1, S)
        roots = rotations.new_zeros(rotations.shape[:-2] + (3,))
        poses = decode_poses(
            rotations, lengths, roots, self.skeleton, self.cfg.rot_rep_dim
        )
        return poses, scores


def concat_hyp_and_scores(hypothesis: torch.Tensor,
                          scores: torch.Tensor) -> torch.Tensor:
    """(B, H, L, J, 3) + (B, H, L, 1) -> (B, H, L, J, 4): each joint gets
    its hypothesis' score as a fourth channel."""
    expanded = scores[:, :, :, None, :].expand(hypothesis.shape[:-1] + (1,))
    return torch.cat([hypothesis, expanded], dim=-1)


def poses_from_hyp_idx(hypothesis: torch.Tensor,
                       hyp_indices: torch.Tensor) -> torch.Tensor:
    """(B, H, L, J, 3) gathered at (B, L) hypothesis indices -> (B, L, J, 3)."""
    b, _, l, j, c = hypothesis.shape
    idx = hyp_indices[:, None, :, None, None].expand(b, 1, l, j, c)
    return torch.gather(hypothesis, 1, idx)[:, 0]


def aggregate_hypotheses(
    hypothesis: torch.Tensor,
    scores: Optional[torch.Tensor] = None,
    mode: str = "weighted_ave",
    ground_truth: Optional[torch.Tensor] = None,
):
    """Aggregate K hypotheses into one pose.

    - ``weighted_ave``: score-weighted mean over H (the serving path);
    - ``best_score``: the argmax-score hypothesis per (B, L);
    - ``oracle``: the WTA winner against ``ground_truth``; returns
      (its unweighted MPJPE per (B, L), its poses).
    """
    if mode == "weighted_ave":
        if scores is None:
            raise ValueError("Scores required for weighted average.")
        return torch.sum(hypothesis * scores[..., None], dim=1)
    if mode == "best_score":
        if scores is None:
            raise ValueError("Scores required for best_score mode.")
        return poses_from_hyp_idx(hypothesis, torch.argmax(scores, dim=1)[..., 0])
    if mode == "oracle":
        if ground_truth is None:
            raise ValueError("Ground truth required for oracle.")
        oracle_mpjpe, oracle_idx = wta_l2_loss_and_activate_head(
            hypothesis, ground_truth, weights=None, squared=False
        )
        return oracle_mpjpe, poses_from_hyp_idx(hypothesis, oracle_idx)
    raise ValueError(
        "Only best_score, weighted_ave and oracle modes are implemented. "
        f"Got {mode}."
    )
