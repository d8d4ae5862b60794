"""MixSTE spatio-temporal transformer trunk (PyTorch, fold layout).

Port of ``manipose_tpu/models/mix_ste.py``: alternating spatial attention
over J joints (batch folded as B*L) and temporal attention over L frames
(batch folded as B*J), depth x 2 blocks, shared post-block LayerNorms,
learned positional tables and a LayerNorm + Linear head.

``MixSTEConfig.layout="joint_major"`` keeps one persistent (B, J, L, C)
residual stream: temporal blocks fold it to (B*J, L, C) by a reshape, and
spatial blocks run on it whole, their attention over J with (B, L, h) as
batch (K3/K4 read those windows in place); one transpose in, one out. Same
math as the fold layout, and one generator gives both layouts the same
drop-path masks (per (b, l) row in spatial blocks, per (b, j) row in
temporal ones). ``MixSTEConfig.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``): its drop-path masks are drawn
before the checkpointed call, in the plain block's order, and passed in,
so a remat step gives the plain step's gradients and leaves the generator
where the plain step leaves it. Parameter names
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

``MixSTEConfig.ring`` (a ``parallel.RingSpec``, with ``attn_impl="ring"``)
runs every temporal block's attention as ring attention with the frame
axis split over the spec's mesh axis (``parallel/ring_attention.py``),
while the spatial blocks stay on K3/K4, as the JAX package's ring trunk
keeps them on XLA (``manipose_tpu/models/mix_ste.py:398-445``). Under
tensor parallelism (``parallel.shard_params``) an Attention or Mlp holds
its rank's heads or hidden slice and the ``model`` group in ``tp``: its
input passes :func:`~..parallel.comm.copy_to_group`, its row-parallel
output is summed over the group, and the proj and fc2 biases are added
once, after the sum.

``MixSTEConfig.quant`` builds the int8 serving variant (``ops/quant.py``),
as the JAX package's ``quant`` flag does: qkv, proj, fc1 and fc2 become
``QuantLinear``s, and an MLP runs fc1 -> exact GELU -> fc2 through two of
them, bypassing K5 as the JAX quant branch bypasses the fused MLP. The
attention core stays on K1/K3. Its parameter layout differs (``weight_q``
and ``scale`` in place of ``weight``), so float weights go through
``quantize_state_dict`` first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.cuda_linear import linear
from ..ops.cuda_mlp import fused_mlp
from ..ops.quant import QuantLinear
from ..parallel.comm import copy_to_group, reduce_from_group


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
    quant: bool = False  # int8 serving (qkv, proj, fc1, fc2)
    # residual-stream layout: "fold" (the reference's) or "joint_major"
    layout: str = "fold"
    # recompute every block in the backward pass (activation memory for time)
    remat: bool = False
    # the JAX package's kernel choice, read to refuse what it refuses with
    # joint-major and to run "ring"; on the card every other attention runs
    # the port's kernels
    attn_impl: str = "xla"
    # the sharding plan of attn_impl="ring" (parallel.RingSpec)
    ring: Optional[object] = None

    def drop_path_rates(self):
        return np.linspace(0.0, self.drop_path_rate, self.depth).tolist()

    @property
    def readout_div(self) -> float:
        """MuReadout width multiplier (the readout input is divided by it)."""
        return (self.embed_dim / self.mup_base_width) if self.mup else 1.0


class Dense(nn.Linear):
    """``nn.Linear`` (same parameters and state-dict names) that computes
    as ``flax.linen.Dense(dtype=compute_dtype)``: input, weight and bias
    cast to ``compute_dtype``, the output in it. The product is
    ``ops.cuda_linear.linear``: on the card, fp32 at widths it takes (the
    C = 512 trunks' qkv and proj) runs its wgmma kernels, the rest
    ``F.linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return linear(x.to(dt), self.weight.to(dt), bias)


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


def _linear(in_features: int, out_features: int, bias: bool, dtype: torch.dtype,
            quant: bool) -> nn.Module:
    if quant:
        return QuantLinear(in_features, out_features, bias=bias, compute_dtype=dtype)
    return Dense(in_features, out_features, bias=bias, compute_dtype=dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2, run as one fused kernel (K5) on operands
    cast to the compute dtype, as the JAX package's fused path takes them;
    under ``quant`` as two ``QuantLinear``s around ``F.gelu``
    (``mix_ste.py:133-141`` of the JAX package)."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32, quant: bool = False):
        super().__init__()
        if quant:
            self.fc1 = QuantLinear(in_features, hidden_features, compute_dtype=dtype)
            self.fc2 = QuantLinear(hidden_features, in_features, compute_dtype=dtype)
        else:
            self.fc1 = nn.Linear(in_features, hidden_features)
            self.fc2 = nn.Linear(hidden_features, in_features)
        self.dtype = dtype
        self.quant = quant
        self.tp = None  # the tensor-parallel group (parallel.shard_params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return self.fc2(F.gelu(self.fc1(x)))
        dt = self.dtype
        b2 = self.fc2.bias.to(dt)
        if self.tp is not None:
            # fc1 column-parallel, fc2 row-parallel: b2 after the sum
            x = copy_to_group(x, self.tp)
            b2 = torch.zeros_like(b2)
        y = fused_mlp(
            x.reshape(-1, x.shape[-1]).to(dt),
            self.fc1.weight.to(dt), self.fc1.bias.to(dt),
            self.fc2.weight.to(dt), b2,
        )
        y = y.reshape(x.shape)
        if self.tp is not None:
            y = reduce_from_group(y, self.tp) + self.fc2.bias.to(dt)
        return y


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, comb: bool = False,
                 mup: bool = False, dtype: torch.dtype = torch.float32,
                 quant: bool = False, ring: Optional[object] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim = dim // num_heads
        self.scale = qk_scale or ((1.0 / head_dim) if mup else head_dim**-0.5)
        self.comb = comb
        self.ring = ring
        self.tp = None  # the tensor-parallel group (parallel.shard_params)
        self.dtype = dtype
        self.qkv = _linear(dim, dim * 3, qkv_bias, dtype, quant)
        self.proj = _linear(dim, dim, True, dtype, quant)

    def _ring(self, qkv: torch.Tensor) -> torch.Tensor:
        from ..parallel.ring_attention import ring_attention

        b, n, _ = qkv.shape
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, self.head_dim).permute(
            2, 0, 3, 1, 4).unbind(0)
        spec = self.ring
        out = ring_attention(q, k, v, self.scale, spec.mesh, spec.axis, spec.batch_axis)
        return out.transpose(1, 2).reshape(b, n, self.num_heads * self.head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = copy_to_group(x, self.tp)
        qkv = self.qkv(x)
        if self.ring is not None:
            out = self._ring(qkv)
        else:
            # the kernels read q, k and v in place from the qkv projection
            # and their backward writes its gradient whole
            out = multi_head_attention(qkv, self.num_heads, self.scale, comb=self.comb)
        if self.tp is None:
            return self.proj(out)
        # row-parallel proj: the bias once, after the sum over the group
        dt = self.dtype
        out = F.linear(out.to(dt), self.proj.weight.to(dt))
        return reduce_from_group(out, self.tp) + self.proj.bias.to(dt)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm semantics): the identity unless
    training with a nonzero rate, then one mask per folded-batch row, drawn
    from ``generator`` (a ``torch.Generator`` on the input's device, set by
    :func:`set_drop_path_generator`; the global RNG is never drawn from).
    ``keep_axes`` lists the axes the mask varies over (the others
    broadcast): (0,) per folded-batch row; (0, 2) per (b, l) for a
    joint-major spatial block on (B, J, L, C), whose draw of B*L values
    gives the fold layout's (B*L, 1, 1) masks. The output keeps the input's
    dtype."""

    def __init__(self, rate: float = 0.0, keep_axes: tuple = (0,)):
        super().__init__()
        self.rate = rate
        self.keep_axes = keep_axes
        self.generator: Optional[torch.Generator] = None

    def active(self) -> bool:
        return self.training and self.rate != 0.0

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The mask for ``x`` (None when inactive): one draw from the
        generator."""
        shape = tuple(n if i in self.keep_axes else 1 for i, n in enumerate(x.shape))
        return self.draw_shape(shape, x.device)

    def draw_shape(self, shape: tuple, device) -> Optional[torch.Tensor]:
        """A mask of ``shape`` (None when inactive): one draw from the
        generator."""
        if not self.active():
            return None
        if self.generator is None:
            raise RuntimeError(
                "DropPath needs a generator in training; call "
                "set_drop_path_generator (the train step does)"
            )
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: one drawn beforehand (by :meth:`draw`), else drawn now."""
        if not self.active():
            return x
        if mask is None:
            mask = self.draw(x)
        return x * mask / (1.0 - self.rate)


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
                 mup: bool = False, dtype: torch.dtype = torch.float32,
                 quant: bool = False, drop_path_keep_axes: tuple = (0,),
                 ring: Optional[object] = None):
        super().__init__()
        self.residual_scale = residual_scale
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, mup=mup,
                              dtype=dtype, quant=quant, ring=ring)
        self.drop_path = DropPath(drop_path, drop_path_keep_axes)
        self.norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, quant)

    def forward(self, x: torch.Tensor, mask1: Optional[torch.Tensor] = None,
                mask2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask1``/``mask2``: the drop-path masks of the attention and MLP
        branches when drawn beforehand (remat), else drawn here, in that
        order."""
        x = x * self.residual_scale + self.drop_path(self.attn(self.norm1(x)), mask1)
        x = x * self.residual_scale + self.drop_path(self.mlp(self.norm2(x)), mask2)
        return x

    def checkpointed(self, x: torch.Tensor) -> torch.Tensor:
        """The block under ``torch.utils.checkpoint``: both masks drawn
        first (the residual stream has the branches' shape) and passed in,
        so the recompute reuses them; nothing inside draws from a default
        generator, so no RNG state is stashed."""
        mask1 = self.drop_path.draw(x)
        mask2 = self.drop_path.draw(x)
        return checkpoint(self, x, mask1, mask2, use_reentrant=False,
                          preserve_rng_state=False)


class MixSTE(nn.Module):
    """Full MixSTE trunk. Input (B, L, J, in_chans) -> (B, L, J, out_dim).

    ``use_patch_embed=False`` takes pre-embedded input (the segments
    trunk); ``apply_head=False`` returns trunk features for external heads
    (the rMCL heads).
    """

    def __init__(self, cfg: MixSTEConfig, use_patch_embed: bool = True,
                 apply_head: bool = True):
        super().__init__()
        if cfg.layout not in ("fold", "joint_major"):
            raise ValueError(f"layout={cfg.layout!r} is not one of 'fold', 'joint_major'")
        # the JAX package's refusal (manipose_tpu/models/mix_ste.py:412-418):
        # its joint-major spatial attention is an XLA einsum, so a spatial
        # kernel choice ("pallas") is refused; "pallas_temporal" and "ring"
        # keep spatial attention on XLA and pass
        spatial_impl = ("xla" if cfg.attn_impl in ("pallas_temporal", "ring")
                        else cfg.attn_impl)
        if cfg.layout == "joint_major" and spatial_impl not in ("xla", "xla_direct"):
            raise ValueError(
                f"layout='joint_major' runs spatial attention over the J axis of "
                f"the joint-major stream; attn_impl={cfg.attn_impl!r} is fold-layout "
                "only (use 'xla', 'xla_direct', 'pallas_temporal' or 'ring')"
            )
        if cfg.attn_impl == "ring" and cfg.ring is None:
            raise ValueError("attn_impl='ring' needs MixSTEConfig.ring (a RingSpec)")
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

        def blocks(keep_axes=(0,), ring=None):
            return nn.ModuleList(
                Block(c, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                      cfg.qk_scale, dpr[i], residual_scale, cfg.mup, dt,
                      cfg.quant, keep_axes, ring)
                for i in range(cfg.depth)
            )

        # joint-major spatial blocks mask per (b, l), as the fold's (B*L) rows
        self.STEblocks = blocks((0, 2) if cfg.layout == "joint_major" else (0,))
        self.TTEblocks = blocks(ring=cfg.ring if cfg.attn_impl == "ring" else None)
        self.Spatial_norm = LayerNorm(c, 1e-6, dt)
        self.Temporal_norm = LayerNorm(c, 1e-6, dt)
        if apply_head:
            self.head = nn.Sequential(
                LayerNorm(c, 1e-5, dt), Dense(c, cfg.out_dim, compute_dtype=dt)
            )

    def _block(self, block: Block, x: torch.Tensor) -> torch.Tensor:
        """``block`` on ``x``, recomputed in the backward pass under remat."""
        if self.cfg.remat and torch.is_grad_enabled():
            return block.checkpointed(x)
        return block(x)

    def _spatial(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """One spatial block on (B, L, J, C): fold L into the batch."""
        b, l, j, c = x.shape
        x = self.Spatial_norm(self._block(self.STEblocks[i], x.reshape(b * l, j, c)))
        return x.reshape(b, l, j, c)

    def _temporal(self, x: torch.Tensor, i: int, pos=None) -> torch.Tensor:
        """One temporal block on (B, L, J, C): fold J into the batch."""
        b, l, j, c = x.shape
        x = x.transpose(1, 2)  # (B, J, L, C)
        if pos is not None:
            x = x + pos.to(x.dtype)
        x = self._block(self.TTEblocks[i], x.reshape(b * j, l, c))
        x = self.Temporal_norm(x)
        return x.reshape(b, j, l, c).transpose(1, 2)

    def _temporal_jm(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """One temporal block on joint-major (B, J, L, C): the fold to
        (B*J, L, C) is a reshape, no copy."""
        b, j, l, c = x.shape
        z = self._block(self.TTEblocks[i], x.reshape(b * j, l, c))
        return self.Temporal_norm(z).reshape(b, j, l, c)

    def _trunk_joint_major(self, x: torch.Tensor) -> torch.Tensor:
        """The joint-major body: one transpose in, one out; every block in
        between runs on the (B, J, L, C) stream, in the fold path's order."""
        x = x.transpose(1, 2).contiguous()  # (B, J, L, C)
        x = self.Spatial_norm(self._block(self.STEblocks[0], x))
        x = x + self.Temporal_pos_embed.to(x.dtype)
        x = self._temporal_jm(x, 0)
        for i in range(1, self.cfg.depth):
            x = self.Spatial_norm(self._block(self.STEblocks[i], x))
            x = self._temporal_jm(x, i)
        return x.transpose(1, 2).contiguous()

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
        if cfg.layout == "joint_major":
            return self._trunk_joint_major(x)
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
