"""MotionBERT's DSTformer (Zhu et al., ICCV 2023, arXiv 2210.06551), the
dual-stream spatio-temporal transformer that MotionBERT fine-tunes for 3D
pose lifting (``lib/model/DSTformer.py`` of the MotionBERT repository,
settings of ``configs/pose3d/MB_ft_h36m.yaml``).

On (B, F, J, 3) keypoints (x, y, confidence), in MotionBERT's order:

- ``x = joints_embed(x) + pos_embed`` (per joint), then ``+ temp_embed[:F]``
  (per frame), once, at the input; the stream is kept folded as
  (B*F, J, C), the reference's layout;
- at each depth i two streams from the same x: ``blocks_st[i]`` runs
  spatial attention, MLP, temporal attention, MLP, and ``blocks_ts[i]`` the
  same four sub-blocks with the temporal pair first, each sub-block
  pre-norm (LayerNorm eps 1e-6) with a residual; then
  ``x = a0 x_st + a1 x_ts`` with ``(a0, a1) = softmax(ts_attn[i]([x_st,
  x_ts]))``, the learned fusion (``ops.cuda_fusion``);
- ``norm``, then ``pre_logits`` (Linear and tanh) and ``head`` (Linear to
  3 coordinates).

A (B, F, J, 2) input gets a confidence of 1 appended, as MotionBERT's data
reader does when no detector score is given, so the loader, the flips,
TTA and serving stay two-channel. Parameter names are MotionBERT's
(``blocks_st.{i}.attn_s.qkv``, ``norm1_t``, ``mlp_s.fc1``, ``ts_attn.{i}``,
``pre_logits.fc``, ``head``, ...), so a MotionBERT state dict loads with
``strict=True``. Its published setting has no drop-path and no dropout,
and neither has this module.

On the card the spatial attention runs K3 (backward K4), the temporal
attention over F > 32 frames K1 (K2), every MLP K5 (K6) and every fusion
the fusion kernels; on the CPU their plain versions. Under
``dtype=bfloat16`` the activations are bf16 as in ``mix_ste`` and the
fusion computes on fp32 copies of the two streams. Each fusion is a span
``model.fuse`` (``utils.profiling``) with the count ``rows`` (B*F*J): five a
forward at the published depth.

``init_weights`` draws MotionBERT's own initialisation from a seed:
Linear weights and the positional tables normal with deviation 0.02 (timm's
``trunc_normal_`` at MotionBERT's bounds of +-2 cuts nothing at that
deviation), biases 0, LayerNorms at 1 and 0, and each ``ts_attn`` at weight
0 and bias 0.5, so every fusion starts at a0 = a1 = 1/2.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch import nn

from ..ops.cuda_fusion import stream_fusion
from ..utils import profiling
from .mix_ste import Attention, Dense, LayerNorm, Mlp


@dataclasses.dataclass(frozen=True)
class DSTformerConfig:
    """Hyper-parameters of a DSTformer (MotionBERT's names in comments)."""

    num_joints: int = 17
    maxlen: int = 243
    in_chans: int = 3  # dim_in
    embed_dim: int = 512  # dim_feat
    dim_rep: int = 512
    depth: int = 5
    num_heads: int = 8
    mlp_ratio: float = 2.0
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32


class DSTBlock(nn.Module):
    """One stream's block at one depth: spatial and temporal attention, each
    followed by an MLP, in the order ``order`` ("st" or "ts")."""

    def __init__(self, cfg: DSTformerConfig, order: str):
        super().__init__()
        c, dt = cfg.embed_dim, cfg.dtype
        self.order = order
        hidden = int(c * cfg.mlp_ratio)
        self.norm1_s = LayerNorm(c, 1e-6, dt)
        self.norm1_t = LayerNorm(c, 1e-6, dt)
        self.attn_s = Attention(c, cfg.num_heads, dtype=dt)
        self.attn_t = Attention(c, cfg.num_heads, dtype=dt)
        self.norm2_s = LayerNorm(c, 1e-6, dt)
        self.norm2_t = LayerNorm(c, 1e-6, dt)
        self.mlp_s = Mlp(c, hidden, dt)
        self.mlp_t = Mlp(c, hidden, dt)

    def _spatial(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn_s(self.norm1_s(x))
        return x + self.mlp_s(self.norm2_s(x))

    def _temporal(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        """Attention over the frames of (B*F, J, C): the normed stream is
        refolded to (B*J, F, C) and the result back."""
        bf, j, c = x.shape
        b = bf // frames
        h = self.norm1_t(x).reshape(b, frames, j, c).transpose(1, 2).reshape(b * j, frames, c)
        h = self.attn_t(h).reshape(b, j, frames, c).transpose(1, 2).reshape(bf, j, c)
        x = x + h
        return x + self.mlp_t(self.norm2_t(x))

    def forward(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        if self.order == "st":
            return self._temporal(self._spatial(x), frames)
        return self._spatial(self._temporal(x, frames))


class DSTformer(nn.Module):
    """(B, F, J, 3 or 2) keypoints -> (B, F, J, 3) poses."""

    def __init__(self, cfg: DSTformerConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.embed_dim, cfg.dtype
        self.joints_embed = Dense(cfg.in_chans, c, compute_dtype=dt)
        self.blocks_st = nn.ModuleList(DSTBlock(cfg, "st") for _ in range(cfg.depth))
        self.blocks_ts = nn.ModuleList(DSTBlock(cfg, "ts") for _ in range(cfg.depth))
        self.norm = LayerNorm(c, 1e-6, dt)
        self.pre_logits = nn.Sequential(collections.OrderedDict(
            fc=Dense(c, cfg.dim_rep, compute_dtype=dt), act=nn.Tanh()))
        self.head = Dense(cfg.dim_rep, 3, compute_dtype=dt)
        self.temp_embed = nn.Parameter(torch.zeros(1, cfg.maxlen, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, c))
        self.ts_attn = nn.ModuleList(nn.Linear(2 * c, 2) for _ in range(cfg.depth))

    def init_weights(self, seed: int) -> "DSTformer":
        """MotionBERT's initialisation (module docstring), drawn from a
        ``torch.Generator`` seeded with ``seed``, module by module in
        ``modules()`` order, then the positional tables."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.normal_(0.0, 0.02, generator=gen)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            self.temp_embed.normal_(0.0, 0.02, generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
            for fuse in self.ts_attn:
                fuse.weight.zero_()
                fuse.bias.fill_(0.5)
        return self

    def _fuse(self, i: int, x_st: torch.Tensor, x_ts: torch.Tensor) -> torch.Tensor:
        shape = x_st.shape
        c = shape[-1]
        lin = self.ts_attn[i]
        with profiling.span("model.fuse", rows=x_st.numel() // c):
            x = stream_fusion(x_st.reshape(-1, c).float(), x_ts.reshape(-1, c).float(),
                              lin.weight, lin.bias)
        return x.to(self.cfg.dtype).reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, f, j, chans = x.shape
        if j != cfg.num_joints or f > cfg.maxlen:
            raise ValueError(f"expected at most {cfg.maxlen} frames of {cfg.num_joints} "
                             f"joints, got {f} of {j}")
        if chans == cfg.in_chans - 1:  # no confidence given: 1, as MotionBERT fills it
            x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        elif chans != cfg.in_chans:
            raise ValueError(f"expected {cfg.in_chans} or {cfg.in_chans - 1} input channels, "
                             f"got {chans}")
        dt = cfg.dtype
        x = self.joints_embed(x.to(dt)) + self.pos_embed.to(dt)
        x = (x + self.temp_embed[:, :f].to(dt)).reshape(b * f, j, -1)
        for i, (st, ts) in enumerate(zip(self.blocks_st, self.blocks_ts)):
            x = self._fuse(i, st(x, f), ts(x, f))
        x = self.norm(x).reshape(b, f, j, -1)
        return self.head(self.pre_logits(x))
