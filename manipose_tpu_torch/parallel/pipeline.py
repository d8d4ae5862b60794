"""Pipeline parallelism: GPipe over a mesh axis.

Port of ``manipose_tpu/parallel/pipeline.py:44-142``. The S stages live
one a rank along the ``axis`` group; the batch splits into M microbatches
and the schedule runs M + S - 1 ticks. At tick t stage s works on
microbatch t - s: stage 0 takes microbatch t of the input, every other
stage the activation it received at the end of tick t - 1, and the last
stage's output at tick t is microbatch t - (S - 1) of the result. After
each tick the activations move one hop around the ring
(:func:`~.comm.rotate`; the last tick's hop is not made, as its result
would not be read). The last stage's buffer is summed over the group
(every other stage holds zeros), so every rank ends with the result. The
bubble is (S - 1)/(M + S - 1) of the ticks; a stage skips the compute of a
tick that holds no microbatch (the JAX version computes and discards it).

Autograd through this is pipelined backprop: the backward of each hop is
the reverse hop, and an anchor threaded through the hops orders their
backward passes the same way on every rank. A rank's stage parameters get
their gradient on that rank only.

Each rank holds its own rows of the batch: under ``data_axis`` its shard
of the global batch (placed by ``mesh.shard_batch``), and each data shard
runs its own pipeline over its ``axis`` group, as in the JAX version.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .comm import group_rank, group_size, reduce_from_group, rotate


def run_pipeline(stage_fn: Callable, x: torch.Tensor, group, microbatches: int,
                 pass_tick: bool = False) -> torch.Tensor:
    """GPipe of this rank's stage ``stage_fn(x_mb)`` (``stage_fn(x_mb, t)``
    with ``pass_tick``) over ``group``, on this rank's batch ``x``; the
    activations keep one shape across stages. Returns the last stage's
    output on every rank."""
    n_stages, s = group_size(group), group_rank(group)
    m = microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    xs = x.reshape(m, b // m, *x.shape[1:])
    state = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0]) for _ in range(m)]
    anchor = (x.new_zeros((), dtype=torch.float32).requires_grad_()
              if torch.is_grad_enabled() and n_stages > 1 else None)
    ticks = m + n_stages - 1
    for t in range(ticks):
        if 0 <= t - s < m:
            inp = xs[t] if s == 0 else state
            y = stage_fn(inp, t) if pass_tick else stage_fn(inp)
        else:  # a bubble tick: this stage holds no microbatch
            y = torch.zeros_like(xs[0])
        if s == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        if t < ticks - 1:
            state, anchor = rotate(y, group, anchor)
    out = reduce_from_group(torch.stack(outs), group)
    if anchor is not None:
        # makes every hop's backward reachable from the result (a zero term)
        out = out + (anchor * 0).to(out.dtype)
    return out.reshape(b, *x.shape[1:])


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor, mesh,
                   axis: str = "pipe", microbatches: int = 8, data_axis: str = None,
                   pass_tick: bool = False) -> torch.Tensor:
    """Apply S sequential stages as a GPipe pipeline over ``axis`` of
    ``mesh``: ``stage_fn(params, x_mb)`` (``stage_fn(params, x_mb, t)`` with
    ``pass_tick``) applies one stage to one microbatch. ``stacked_params``:
    a pytree whose tensors are the per-stage parameters stacked on a
    leading axis of size S (:func:`stack_stage_params`); this rank's stage
    takes its slice. ``x``: this rank's (B, ...) rows (its shard of the
    batch under ``data_axis``), B divisible by ``microbatches``. Returns
    stage_{S-1}(... stage_0(x)) on every rank of the group."""
    del data_axis  # the batch was split when it was placed
    group = mesh.get_group(axis)
    n_stages = group_size(group)
    for leaf in tree_leaves(stacked_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"stacked param leading axis {leaf.shape[0]} != pipe size "
                             f"{n_stages}")
    s = group_rank(group)
    params = tree_map(lambda p: p[s], stacked_params)
    if pass_tick:
        return run_pipeline(lambda h, t: stage_fn(params, h, t), x, group, microbatches,
                            pass_tick=True)
    return run_pipeline(lambda h: stage_fn(params, h), x, group, microbatches)


def stack_stage_params(per_stage_params):
    """Stack a list of identically shaped per-stage pytrees into the
    leading-axis layout :func:`pipeline_apply` takes."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)
