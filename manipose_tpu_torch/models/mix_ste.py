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

Precision follows the JAX package's ``dtype`` policy: parameters stay
fp32, activations run in ``MixSTEConfig.dtype`` (fp32 or bf16). Under bf16
the trunk casts its input and the positional tables to bf16; every Linear
computes as ``flax.linen.Dense(dtype=bf16)`` does (input, weight and bias
cast to bf16, bf16 out); every LayerNorm as ``flax.linen.LayerNorm(
dtype=bf16)`` does (statistics and affine in fp32, the result rounded
once to bf16); the fused MLP gets bf16 operands cast from the fp32
parameters. The casts happen at call time, so autograd carries each
gradient back to its fp32 parameter; at fp32 every cast is a no-op.

On the card the attention cores run kernels K1/K3 (backward K2/K4) and
every MLP runs the fused kernel K5 (backward K6); on the CPU their plain
versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
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
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32

    def drop_path_rates(self):
        return np.linspace(0.0, self.drop_path_rate, self.depth).tolist()

    @property
    def readout_div(self) -> float:
        """MuReadout width multiplier (the readout input is divided by it)."""
        return (self.embed_dim / self.mup_base_width) if self.mup else 1.0


class Dense(nn.Linear):
    """``nn.Linear`` (same parameters and state-dict names) that computes
    as ``flax.linen.Dense(dtype=compute_dtype)``: input, weight and bias
    cast to ``compute_dtype``, the output in it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (fp32 affine, same state-dict names) that computes
    as ``flax.linen.LayerNorm(dtype=compute_dtype)``: statistics and affine
    in fp32, the result rounded once to ``compute_dtype``."""

    def __init__(self, dim: int, eps: float,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # on an fp32 copy: CUDA's layer_norm refuses a bf16 input with fp32
        # weights (torch 2.11)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2, run as one fused kernel (K5) on operands
    cast to the compute dtype, as the JAX package's fused path takes them."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = fused_mlp(
            x.reshape(-1, x.shape[-1]).to(dt),
            self.fc1.weight.to(dt), self.fc1.bias.to(dt),
            self.fc2.weight.to(dt), self.fc2.bias.to(dt),
        )
        return y.reshape(x.shape)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, comb: bool = False,
                 mup: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = qk_scale or ((1.0 / head_dim) if mup else head_dim**-0.5)
        self.comb = comb
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, compute_dtype=dtype)
        self.proj = Dense(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the kernels read q, k and v in place from the qkv projection and
        # their backward writes its gradient whole
        out = multi_head_attention(self.qkv(x), self.num_heads, self.scale,
                                   comb=self.comb)
        return self.proj(out)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics): the identity unless
    training with a nonzero rate, then one mask per folded-batch row, drawn
    from ``generator`` (a ``torch.Generator`` on the input's device, set by
    :func:`set_drop_path_generator`; the global RNG is never drawn from).
    The output keeps the input's dtype."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "DropPath needs a generator in training; call "
                "set_drop_path_generator (the train step does)"
            )
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                          generator=self.generator, device=x.device) < keep
        return x * mask / keep


def set_drop_path_generator(model: nn.Module,
                            generator: Optional[torch.Generator]) -> None:
    """Give every DropPath of ``model`` the generator its masks come from."""
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.generator = generator


class Block(nn.Module):
    """Pre-norm attention + MLP block with residual scaling."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, residual_scale: float = 1.0,
                 mup: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual_scale = residual_scale
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, mup=mup,
                              dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

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
        c, dt = cfg.embed_dim, cfg.dtype
        if use_patch_embed:
            self.Spatial_patch_to_embedding = Dense(cfg.in_chans, c,
                                                    compute_dtype=dt)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_joints, c))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_frame, c))
        residual_scale = (1.0 / np.sqrt(cfg.depth)) if cfg.mup else 1.0
        dpr = cfg.drop_path_rates()

        def blocks():
            return nn.ModuleList(
                Block(c, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                      cfg.qk_scale, dpr[i], residual_scale, cfg.mup, dt)
                for i in range(cfg.depth)
            )

        self.STEblocks = blocks()
        self.TTEblocks = blocks()
        self.Spatial_norm = LayerNorm(c, 1e-6, dt)
        self.Temporal_norm = LayerNorm(c, 1e-6, dt)
        if apply_head:
            self.head = nn.Sequential(
                LayerNorm(c, 1e-5, dt), Dense(c, cfg.out_dim, compute_dtype=dt)
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
            x = x + pos.to(x.dtype)
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
        # the fp32 positional tables are cast to the compute dtype, else
        # the add would promote the residual stream back to fp32
        x = x.to(cfg.dtype)
        if self.use_patch_embed:
            x = self.Spatial_patch_to_embedding(x)
        x = x + self.Spatial_pos_embed.to(cfg.dtype)
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
