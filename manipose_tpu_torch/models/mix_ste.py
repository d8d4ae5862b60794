"""MixSTE spatio-temporal transformer trunk (PyTorch, fold layout).

Port of ``manipose_tpu/models/mix_ste.py``: alternating spatial attention
over J joints (batch folded as B*L) and temporal attention over L frames
(batch folded as B*J), depth x 2 blocks, shared post-block LayerNorms,
learned positional tables and a LayerNorm + Linear head. Parameter names
are the reference's state-dict names (``Spatial_patch_to_embedding``,
``STEblocks.{i}.attn.qkv``, ``head.0`` ...), so a reference ``.pth`` loads
with ``strict=True``.

Numerics as in the JAX package:
- block and shared LayerNorms use eps 1e-6, the head's LayerNorm 1e-5;
- GELU is the exact erf form;
- the attention scale is head_dim**-0.5, or 1/head_dim under muP
  (overridable through qk_scale);
- the residual scale is 1/sqrt(depth) under muP, else 1; the head's input
  is divided by ``readout_div`` under muP;
- stochastic depth rates follow linspace(0, drop_path_rate, depth).

On the card the attention cores run kernels K1/K3 and every MLP runs the
fused kernel K5; on the CPU their plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.cuda_mlp import fused_mlp


@dataclasses.dataclass(frozen=True)
class MixSTEConfig:
    """Hyper-parameters of one MixSTE trunk."""

    num_frame: int = 243
    num_joints: int = 17
    in_chans: int = 2
    out_dim: int = 3
    embed_dim: int = 512
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_path_rate: float = 0.2
    mup: bool = False
    mup_base_width: int = 64

    def drop_path_rates(self):
        return np.linspace(0.0, self.drop_path_rate, self.depth).tolist()

    @property
    def readout_div(self) -> float:
        """MuReadout width multiplier (the readout input is divided by it)."""
        return (self.embed_dim / self.mup_base_width) if self.mup else 1.0


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2, run as one fused kernel (K5)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fused_mlp(
            x.reshape(-1, x.shape[-1]),
            self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias,
        )
        return y.reshape(x.shape)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, comb: bool = False,
                 mup: bool = False):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or ((1.0 / head_dim) if mup else head_dim**-0.5)
        self.comb = comb
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        # strided (B, h, N, d) views of the one qkv tensor: the kernels
        # read them in place
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        out = multi_head_attention(q, k, v, self.scale, comb=self.comb)
        return self.proj(out)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics): the identity unless
    training with a nonzero rate, then one mask per folded-batch row."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          device=x.device) < keep
        return x * mask / keep


class Block(nn.Module):
    """Pre-norm attention + MLP block with residual scaling."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, residual_scale: float = 1.0,
                 mup: bool = False):
        super().__init__()
        self.residual_scale = residual_scale
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, mup=mup)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.residual_scale + self.drop_path(self.attn(self.norm1(x)))
        x = x * self.residual_scale + self.drop_path(self.mlp(self.norm2(x)))
        return x


class MixSTE(nn.Module):
    """Full MixSTE trunk. Input (B, L, J, in_chans) -> (B, L, J, out_dim).

    ``use_patch_embed=False`` takes pre-embedded input (the segments
    trunk); ``apply_head=False`` returns trunk features for external heads
    (the rMCL heads).
    """

    def __init__(self, cfg: MixSTEConfig, use_patch_embed: bool = True,
                 apply_head: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_patch_embed = use_patch_embed
        self.apply_head = apply_head
        c = cfg.embed_dim
        if use_patch_embed:
            self.Spatial_patch_to_embedding = nn.Linear(cfg.in_chans, c)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, c))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_frame, c))
        residual_scale = (1.0 / np.sqrt(cfg.depth)) if cfg.mup else 1.0
        dpr = cfg.drop_path_rates()

        def blocks():
            return nn.ModuleList(
                Block(c, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                      cfg.qk_scale, dpr[i], residual_scale, cfg.mup)
                for i in range(cfg.depth)
            )

        self.STEblocks = blocks()
        self.TTEblocks = blocks()
        self.Spatial_norm = nn.LayerNorm(c, eps=1e-6)
        self.Temporal_norm = nn.LayerNorm(c, eps=1e-6)
        if apply_head:
            self.head = nn.Sequential(
                nn.LayerNorm(c, eps=1e-5), nn.Linear(c, cfg.out_dim)
            )

    def _spatial(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """One spatial block on (B, L, J, C): fold L into the batch."""
        b, l, j, c = x.shape
        x = self.Spatial_norm(self.STEblocks[i](x.reshape(b * l, j, c)))
        return x.reshape(b, l, j, c)

    def _temporal(self, x: torch.Tensor, i: int, pos=None) -> torch.Tensor:
        """One temporal block on (B, L, J, C): fold J into the batch."""
        b, l, j, c = x.shape
        x = x.transpose(1, 2)  # (B, J, L, C)
        if pos is not None:
            x = x + pos
        x = self.TTEblocks[i](x.reshape(b * j, l, c))
        x = self.Temporal_norm(x)
        return x.reshape(b, j, l, c).transpose(1, 2)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, J, C_in) -> (B, L, J, embed_dim) features."""
        cfg = self.cfg
        _, l, j, _ = x.shape
        if l != cfg.num_frame or j != cfg.num_joints:
            raise ValueError(
                f"expected {cfg.num_frame} frames of {cfg.num_joints} joints, "
                f"got {l} of {j}"
            )
        if self.use_patch_embed:
            x = self.Spatial_patch_to_embedding(x)
        x = x + self.Spatial_pos_embed
        x = self._spatial(x, 0)
        x = self._temporal(x, 0, pos=self.Temporal_pos_embed)
        for i in range(1, cfg.depth):
            x = self._temporal(self._spatial(x, i), i)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        if self.apply_head:
            norm, linear = self.head
            x = linear(norm(x) / self.cfg.readout_div)
        return x
