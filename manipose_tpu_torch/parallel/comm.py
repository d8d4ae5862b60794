"""The differentiable collectives of ``parallel/``.

JAX differentiates through ``ppermute`` and ``psum`` inside ``shard_map``
by itself: the VJP of a rotation is the reverse rotation. In PyTorch the
``torch.distributed`` calls are not differentiable, so each collective
that ``parallel/`` runs inside a forward pass is one
``torch.autograd.Function`` here, with its backward written out:

- :func:`rotate`: one hop around a ring (send to rank i+1, receive from
  i-1); backward, the reverse hop. The ring attention rotates K/V with it,
  the pipeline its activations.
- :func:`copy_to_group` (identity forward, all-reduce backward) and
  :func:`reduce_from_group` (all-reduce forward, identity backward):
  Megatron's f and g around a tensor-parallel block.
- :func:`split_to_group` (this rank's chunk forward, all-gather backward)
  and :func:`gather_from_group` (all-gather forward, this rank's chunk
  backward): the ring's way from activations that every rank of the group
  holds whole to a chunk per rank and back.

Every rank of a group holds the same activations outside these calls and
computes the same loss, so each backward hands every rank the gradient of
that one loss: the parameters' gradients are whole on every rank of the
group and need no reduction over it. (``torch.distributed.nn.functional.
all_gather`` reduce-scatters in its backward, which would sum the group's
equal copies of the gradient.)

The backward passes run collectives too, so every rank must run them in
the same order. Autograd orders the nodes of one chain of data; where a
forward has no such chain (the pipeline's rotations, whose received
activations stage 0 never reads), :func:`rotate` threads a 0-dim
``anchor`` from each call into the next, which makes the hops one chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _exchange(t: torch.Tensor, group, hop: int) -> torch.Tensor:
    """Send ``t`` to group rank i+hop and receive the tensor of rank i-hop."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + hop) % n)
    src = dist.get_global_rank(group, (r - hop) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, anchor, group):
        ctx.group = group
        out = _exchange(t, group, 1)
        return out, anchor.clone()

    @staticmethod
    def backward(ctx, grad, grad_anchor):
        back = _exchange(grad, ctx.group, -1)
        return (back if ctx.needs_input_grad[0] else None), grad_anchor, None


def rotate(t: torch.Tensor, group,
           anchor: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One hop around ``group``'s ring: rank i's ``t`` goes to rank i+1 and
    rank i gets rank i-1's. Returns (received, next anchor). With an
    ``anchor`` (a 0-dim tensor that requires grad) the hop is recorded even
    where ``t`` needs no gradient, and its backward comes after that of
    every later hop given the returned anchor; without one (or without
    autograd) it is a plain exchange."""
    if anchor is None or not torch.is_grad_enabled():
        if torch.is_grad_enabled() and t.requires_grad:
            return _Rotate.apply(t, t.new_zeros(()), group)[0], anchor
        return _exchange(t, group, 1), anchor
    return _Rotate.apply(t, anchor, group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return t
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _chunk(grad, ctx.group, ctx.dim), None, None


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group`` (the input of
    a column-parallel product)."""
    return _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the backward passes the gradient through (the
    output of a row-parallel product)."""
    return _ReduceFromGroup.apply(t, group)


def split_to_group(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (``t`` whole on every rank
    of ``group``); the backward all-gathers the chunks' gradients."""
    return _SplitToGroup.apply(t, group, dim)


def gather_from_group(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's chunks concatenated along ``dim``, in rank order; the
    backward keeps this rank's chunk of the gradient."""
    return _GatherFromGroup.apply(t, group, dim)
