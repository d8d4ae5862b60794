"""Attention core of the MixSTE trunk.

Port of ``manipose_tpu/ops/attention.py::multi_head_attention`` for the
fold layout, taking the qkv projection whole: short sequences (N <= 32,
the spatial layout over joints or bones) go to the per-window kernels
K3/K4, longer ones (the temporal layout over frames) to the dense kernels
K1/K2 — the split of ``manipose_tpu/ops/attention.py:87-97``. The
joint-major trunk's spatial attention takes its (B, J, L, 3*h*d) qkv
projection whole as well, over the J axis with (B, L, h) as batch: K3/K4
read each (b, l, h) window in place on the card, with no transposing copy;
:func:`joint_major_attention` is its plain version
(``manipose_tpu/ops/attention.py:125-154``). The transposed-score ``comb``
mode stays plain PyTorch; no configuration enables it.
"""

from __future__ import annotations

import torch

from .cuda_attention import attention, split_heads


def multi_head_attention(
    qkv: torch.Tensor,  # (B, N, 3*h*d), or joint-major (B, J, L, 3*h*d)
    num_heads: int,
    scale: float,
    comb: bool = False,
) -> torch.Tensor:
    """Scaled-dot-product attention over ``num_heads`` heads -> (B, N, h*d)
    (joint-major: (B, J, L, h*d), attention over J)."""
    if not comb:
        return attention(qkv, num_heads, scale)
    if qkv.dim() == 4:
        raise ValueError("comb attention has no joint-major form")
    q, k, v = split_heads(qkv, num_heads)
    attn = torch.softmax(torch.einsum("bhnd,bhne->bhde", q, k) * scale, -1)
    out = torch.einsum("bhde,bhne->bhnd", attn, v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


def joint_major_attention(q, k, v, scale: float) -> torch.Tensor:
    """Spatial attention over the J axis of joint-major (B, J, L, h, d)
    views, with (B, L, h) as batch dims -> (B, J, L, h*d): the plain
    version of the joint-major path, in fp32 and cast back to q's dtype, as
    the JAX package's einsum form computes it."""
    b, j, l, h, d = q.shape
    scores = torch.einsum("bjlhd,bklhd->blhjk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("blhjk,bklhd->bjlhd", probs, v.float())
    return out.reshape(b, j, l, h * d).to(q.dtype)
