"""Ring attention: the sequence axis split over a mesh axis.

Port of ``manipose_tpu/parallel/ring_attention.py:46-150``. Each rank of
the ``axis`` group attends its (N/P)-long chunk of the queries against
every chunk of keys and values, which travel around the ring one hop a
step (:func:`~.comm.rotate`), with a streaming (online-softmax)
accumulation in fp32. The result is exact attention, up to the order of
the sums. No rank ever holds more than one (N/P, N/P) tile of scores.

- A length N that does not divide the ring is zero-padded to the next
  multiple; the pad keys are masked at -1e9, so their softmax weight is
  +0.0 and the online rescale removes what a block of pure padding adds
  before the first real block; pad query rows are sliced off.
- There are P - 1 rotations: the last block is not sent on.
- ``l == 0`` is guarded, so rows of an all-pad ring stay finite.

The JAX version's ``shard_map`` slices the sequence on the way in and
gathers it on the way out. Here every rank of the ``axis`` group holds
the whole (B, H, N, d) activations; it takes its chunk of q, k and v
(:func:`~.comm.split_to_group`) and all-gathers the outputs
(:func:`~.comm.gather_from_group`). The backward passes are those of the
collectives, so autograd differentiates the accumulation itself, as JAX
does.

``batch_axis`` shards the batch in the JAX version. In the port each rank
holds only its own rows of the batch already (``mesh.shard_batch`` placed
them), so the argument changes nothing here; an uneven batch, which the
JAX version replicates, is whatever the rank holds.

The accumulation is plain PyTorch on every device: the temporal attention
of a ring trunk runs no kernel, while its spatial attention and its MLPs
run K3 and K5 on the card as everywhere else in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .comm import gather_from_group, group_rank, group_size, rotate, split_to_group


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """Which mesh, which axis splits the sequence, and which axis the
    batch is split over (the JAX plan's ``batch_axis``)."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis: str = "model"
    batch_axis: Optional[str] = None


def _accumulate(m, l, o, q32, k_blk, v_blk, kmask):
    scores = torch.einsum("bhnd,bhmd->bhnm", q32, k_blk.float())
    scores = torch.where(kmask, scores, torch.full_like(scores, -1e9))
    new_m = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - new_m)
    probs = torch.exp(scores - new_m[..., None])
    l = l * alpha + probs.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum("bhnm,bhmd->bhnd", probs, v_blk.float())
    return new_m, l, o


def _ring_local(q, kv, n: int, scale: float, group) -> torch.Tensor:
    """One rank's chunk of the output. q: (B, H, c, d); kv: (2, B, H, c, d),
    this rank's chunk of keys and values; n: the unpadded length."""
    p, r = group_size(group), group_rank(group)
    c = q.shape[2]
    q32 = q.float() * scale
    m = torch.full(q.shape[:3], -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    o = torch.zeros(q32.shape, dtype=torch.float32, device=q.device)
    positions = torch.arange(c, device=q.device)
    for step in range(p):
        held = (r - step) % p  # the chunk of keys this rank holds now
        kmask = positions + held * c < n
        m, l, o = _accumulate(m, l, o, q32, kv[0], kv[1], kmask)
        if step < p - 1:
            kv, _ = rotate(kv, group)
    out = o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   mesh, axis: str = "model",
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Exact attention (B, H, N, d) -> (B, H, N, d) with the sequence axis
    split over the ``axis`` group of ``mesh``; q, k and v are whole on every
    rank of that group, and so is the result."""
    del batch_axis  # the batch was split when it was placed
    group = mesh.get_group(axis)
    p = group_size(group)
    n = q.shape[2]
    n_pad = -n % p
    qkv = torch.stack([q, k, v])
    if n_pad:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, n_pad))
    local = split_to_group(qkv, group, dim=3)
    out = _ring_local(local[0], local[1:], n, scale, group)
    out = gather_from_group(out, group, dim=2)
    return out[:, :, :n] if n_pad else out
