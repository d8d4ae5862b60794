"""Attention core of the MixSTE trunk.

Port of ``manipose_tpu/ops/attention.py::multi_head_attention`` for the
fold layout: short sequences (N <= 32, the spatial layout over joints or
bones) go to the per-window kernel K3, longer ones (the temporal layout
over frames) to the dense kernel K1 — the split of
``manipose_tpu/ops/attention.py:87-97``. The transposed-score ``comb``
mode stays plain PyTorch; no configuration enables it.
"""

from __future__ import annotations

import torch

from .cuda_attention import PACKED_MAX_N, attention_dense, attention_packed


def multi_head_attention(
    q: torch.Tensor,  # (B, h, N, d)
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    comb: bool = False,
) -> torch.Tensor:
    """Scaled-dot-product attention over pre-split heads -> (B, N, h*d)."""
    b, h, n, d = q.shape
    if comb:
        attn = torch.softmax(torch.einsum("bhnd,bhne->bhde", q, k) * scale, -1)
        out = torch.einsum("bhde,bhne->bhnd", attn, v)
    else:
        kernel = attention_packed if n <= PACKED_MAX_N else attention_dense
        out = kernel(q, k, v, scale)
    return out.transpose(1, 2).reshape(b, n, h * d)
