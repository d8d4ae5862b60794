"""Attention core of the MixSTE trunk.

Port of ``manipose_tpu/ops/attention.py::multi_head_attention`` for the
fold layout, taking the qkv projection whole: short sequences (N <= 32,
the spatial layout over joints or bones) go to the per-window kernels
K3/K4, longer ones (the temporal layout over frames) to the dense kernels
K1/K2 — the split of ``manipose_tpu/ops/attention.py:87-97``. The
transposed-score ``comb`` mode stays plain PyTorch; no configuration
enables it.
"""

from __future__ import annotations

import torch

from .cuda_attention import attention, split_heads


def multi_head_attention(
    qkv: torch.Tensor,  # (B, N, 3*h*d)
    num_heads: int,
    scale: float,
    comb: bool = False,
) -> torch.Tensor:
    """Scaled-dot-product attention over ``num_heads`` heads -> (B, N, h*d)."""
    if not comb:
        return attention(qkv, num_heads, scale)
    q, k, v = split_heads(qkv, num_heads)
    attn = torch.softmax(torch.einsum("bhnd,bhne->bhde", q, k) * scale, -1)
    out = torch.einsum("bhde,bhne->bhnd", attn, v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)
