"""Multi-process launch: the process group, the hybrid mesh, the batch.

Port of ``manipose_tpu/parallel/multihost.py:37-175``. JAX runs one
controller a host over all its devices; PyTorch runs one process a device,
started by ``torchrun``, over a ``torch.distributed`` process group
(``nccl`` on the card, ``gloo`` on CPU ranks):

1. :func:`initialize` brings the group up (the JAX rules: explicit
   arguments win, a partial specification is an error, ``auto`` reads the
   launcher's environment, and with neither it does nothing);
2. :func:`make_hybrid_mesh` lays the ``data`` axis across nodes and the
   ``model`` axis within a node;
3. :func:`global_batch`: each rank feeds its own shard of the batch.

:func:`require_world` is what a driver or ``train()`` calls with its
``parallel`` settings: it joins a ``torchrun`` launch and refuses a world
whose size differs from data x model x pipe.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _init(backend: Optional[str], **kw) -> None:
    backend = backend or _default_backend()
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend, **kw)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               auto: bool = False,
               backend: Optional[str] = None) -> bool:
    """Initialise the process group if this looks like a multi-process
    launch; return whether it did.

    - ``auto=True`` (or ``MANIPOSE_MULTIHOST=1``) with nothing explicit:
      the launcher's environment (``torchrun`` sets MASTER_ADDR,
      MASTER_PORT, RANK and WORLD_SIZE).
    - explicit: all three of ``coordinator_address`` ("host:port"),
      ``num_processes`` and ``process_id``; these win over
      ``MANIPOSE_MULTIHOST``. A partial specification is a ValueError.
    - neither: a single-process run; nothing happens.

    ``backend``: ``nccl`` or ``gloo`` (default: nccl where there is a card).
    """
    auto = auto or os.environ.get("MANIPOSE_MULTIHOST", "") == "1"
    given = (coordinator_address, num_processes, process_id)
    if auto and all(v is None for v in given):
        _init(backend, init_method="env://")
        return True
    if all(v is None for v in given):
        return False
    if any(v is None for v in given):
        missing = [name for name, v in zip(
            ("coordinator_address", "num_processes", "process_id"), given) if v is None]
        raise ValueError(
            f"multi-process launch is partially specified: missing {missing}. Give all "
            "three, or use auto=True / MANIPOSE_MULTIHOST=1 under torchrun")
    _init(backend, init_method=f"tcp://{coordinator_address}",
          world_size=int(num_processes), rank=int(process_id))
    return True


def launched_by_torchrun() -> bool:
    """Whether the launcher's environment names this process's place."""
    return all(v in os.environ for v in _LAUNCHER_VARS)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def require_world(cfg, device=None) -> int:
    """The process count ``cfg.parallel`` asks for (data x model x pipe),
    checked against the process group: under ``torchrun`` the group is
    initialised here if it is not yet (``gloo`` for ``device`` cpu, else
    the default); a count above 1 without a group, or a group of another
    size, is a ValueError that names the launch."""
    pcfg = cfg.get("parallel") or {}
    n = int(pcfg.get("data", 1)) * int(pcfg.get("model", 1)) * int(pcfg.get("pipe", 1))
    if not dist.is_initialized() and n > 1 and launched_by_torchrun():
        cpu = device is not None and torch.device(device).type == "cpu"
        initialize(auto=True, backend="gloo" if cpu else None)
    have = world_size()
    if not dist.is_initialized() and launched_by_torchrun():
        have = int(os.environ["WORLD_SIZE"])  # launched N-wide, for one process
    if have != n:
        raise ValueError(
            f"parallel.data x model x pipe = {n} needs {n} processes, this run has "
            f"{have}: launch it with torchrun --nproc-per-node {n} "
            "(python -m torch.distributed.run) or set the parallel settings to 1")
    return n


def make_hybrid_mesh(data: int, model: int = 1):
    """A (data, model) mesh with ``data`` outer across nodes and ``model``
    within a node. torchrun numbers ranks node by node, so the row-major
    mesh is that layout once ``model`` divides a node's process count."""
    from .mesh import make_mesh

    n = world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    nodes = max(1, n // per_node)
    if nodes == 1:
        return make_mesh(data=data, model=model)
    if not (data % nodes == 0 and data >= nodes):
        raise ValueError(f"data axis ({data}) must be a positive multiple of the node "
                         f"count ({nodes}) so each node holds equal batch shards")
    if (data // nodes) * model != per_node:
        raise ValueError(f"per-node mesh {data // nodes}x{model} must use exactly the "
                         f"{per_node} processes of each node")
    return make_mesh(data=data, model=model)


def global_batch(local_arrays: Sequence, mesh) -> tuple:
    """Each rank's own shard of the global batch (the global batch is the
    shards in ``data`` order; the ranks of one ``model`` or ``pipe`` group
    feed the same shard), as tensors on the mesh's device."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return tuple(torch.as_tensor(a).to(device) for a in local_arrays)


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Align all processes at the point ``name`` marks for the reader;
    nothing in a single process. On gloo a monitored barrier names the
    ranks that did not arrive within ``timeout_ms``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=timedelta(milliseconds=timeout_ms))
    else:
        dist.barrier()
