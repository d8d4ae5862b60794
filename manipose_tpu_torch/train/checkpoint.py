"""Checkpoints of the port's training runs, on ``torch.save``.

Port of ``manipose_tpu/train/checkpoint.py:44-176`` (orbax there). A run
directory holds one directory a tag:

- ``<tag>/model.pth``: ``{"model_pos": state_dict}`` under the reference
  names, for every tag (``best_val``, ``best_mpjpe``,
  ``best_oracle_mpjpe``, ``best_ps_oracle_mpjpe``, ``end`` and the resume
  states), so ``weights.load_torch_checkpoint``, ``run.checkpoint_model``
  and the reference's own drivers load it as it is;
- ``train_state_NNNNNN/train_state.pth``: what else a resume needs, the
  optimizer's ``state_dict`` (Adam's moments and step counts), the count
  of skipped non-finite steps, the drop-path generator's state and the
  count of steps taken;
- ``train_state_NNNNNN/host_state.json``: the scheduler and the epoch to
  restart at, written by the train loop after the commit (the marker that
  the state is whole).

A tag is written into a temporary sibling directory (``<tag>`` +
``.torch-checkpoint-tmp-`` + a suffix), its files and the directory are
fsynced, and it is renamed into place; a tag written again is renamed
away first, the new one renamed in, and the old one deleted. A save
copies what it writes to the host first (pinned buffers, queued on the
current stream, so later in-place updates do not reach it) and, unless
``block``, writes on a background thread as orbax's async save does;
saves run one at a time and ``wait_for_checkpoints`` joins the last.

Under a mesh (``parallel.shard_params``) every rank calls the save: the
weights and Adam's moments are gathered into the single-device layout
(``parallel.mesh.full_state_dict``), so ``Predictor.from_any`` and
``load_torch_checkpoint`` read the files as they read a one-card run's,
and the primary rank alone writes them; the resume state adds every
rank's drop-path generator (``generators``). A restore puts each rank's
part back.

Resume discovery (``find_resume_state``) and pruning follow the JAX
package's rules: numbered ``train_state_NNNNNN`` directories count only
with their ``host_state.json``, the newest such one wins, and temporary
directories are debris. The JAX package's legacy single ``train_state/``
layout is orbax-only and has no counterpart here, and the port reads no
orbax directory (that needs orbax): ``manipose_tpu.train.checkpoint.
save_torch_checkpoint`` turns a JAX run's tag into a ``.pth`` file.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import (
    full_optimizer_state,
    full_state_dict,
    load_full_optimizer_state,
    load_full_state_dict,
)
from ..parallel.multihost import is_primary, world_size
from ..weights import load_torch_checkpoint
from .step import TrainState

TMP_MARK = ".torch-checkpoint-tmp-"
MODEL_FILE = "model.pth"
STATE_FILE = "train_state.pth"
HOST_FILE = "host_state.json"

_names = itertools.count()
_pending: Optional[threading.Thread] = None
_failed: list = []


def _to_host(obj):
    """``obj`` (tensors in dicts and lists) with every tensor copied to the
    host, and an event that marks the card's copies done (None when
    nothing was on the card). Card tensors go into pinned buffers with
    copies queued on the current stream; CPU tensors are cloned."""
    on_card = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                on_card.append(x)
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                return buf.copy_(x.detach(), non_blocking=True)
            return x.detach().clone()
        if isinstance(x, dict):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    host = copy(obj)
    done = None
    if on_card:
        done = torch.cuda.Event()
        done.record()
    return host, done


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit(path: Path, files: dict, done) -> None:
    """Write ``files`` ({name: object}) into a temporary sibling of
    ``path`` and rename it into place."""
    if done is not None:
        done.synchronize()
    tmp = path.with_name(f"{path.name}{TMP_MARK}{os.getpid()}-{next(_names)}")
    tmp.mkdir(parents=True)
    for name, obj in files.items():
        with open(tmp / name, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
    _fsync_dir(tmp)
    if path.exists():
        old = path.with_name(f"{path.name}{TMP_MARK}{os.getpid()}-{next(_names)}")
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    _fsync_dir(path.parent)


def _background(path: Path, files: dict, done) -> None:
    try:
        _commit(path, files, done)
    except BaseException as exc:  # raised on the caller's next save or wait
        _failed.append(exc)


def wait_for_checkpoints() -> None:
    """Block until every background checkpoint write has committed; raise
    what a failed one raised."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _failed:
        raise _failed.pop()


def save_checkpoint(directory, tag: str, what, block: bool = False) -> None:
    """Save ``what`` under ``directory/tag``: a ``TrainState`` (weights and
    the resume state), or a model (weights only).

    Waits for the previous save, copies ``what`` to the host, and returns
    while a background thread writes it, or after writing it with
    ``block=True``. Under a process group every rank calls it and the
    primary rank writes."""
    global _pending
    wait_for_checkpoints()
    files = {}
    if isinstance(what, TrainState):
        files[MODEL_FILE] = {"model_pos": full_state_dict(what.model)}
        files[STATE_FILE] = {
            "optimizer": full_optimizer_state(what.model, what.optimizer),
            "notfinite_count": what.optimizer.notfinite_count,
            "generator": what.generator.get_state(),
            "step": what.step,
        }
        if world_size() > 1:
            generators = [None] * world_size()
            dist.all_gather_object(generators, what.generator.get_state())
            files[STATE_FILE]["generators"] = generators
    else:
        files[MODEL_FILE] = {"model_pos": full_state_dict(what)}
    if not is_primary():
        return
    files, done = _to_host(files)
    path = Path(directory).resolve() / tag
    if block:
        _commit(path, files, done)
        return
    _pending = threading.Thread(target=_background, args=(path, files, done),
                                name=f"checkpoint {tag}", daemon=False)
    _pending.start()


def tag_weights(directory, tag: str) -> Path:
    """``directory/tag/model.pth`` of a port run. A tag directory without it
    is the JAX package's (orbax): refused, naming the way across."""
    tag_dir = Path(directory) / tag
    path = tag_dir / MODEL_FILE
    if not path.is_file():
        if tag_dir.is_dir():
            raise ValueError(
                f"{tag_dir} holds no {MODEL_FILE}: an orbax checkpoint of the JAX "
                "package? The port reads no orbax directory; write it as a .pth "
                "with manipose_tpu.train.checkpoint.save_torch_checkpoint"
            )
        raise FileNotFoundError(f"no checkpoint {path}")
    return path


def restore_checkpoint(directory, tag: str, target):
    """Load ``directory/tag`` into ``target`` and return it: a model (the
    weights), or a ``TrainState`` (weights, optimizer, skipped-step count,
    generator and step count, which a resume state holds)."""
    wait_for_checkpoints()  # the tag may still be committing
    state_dict = load_torch_checkpoint(tag_weights(directory, tag))
    model = target.model if isinstance(target, TrainState) else target
    load_full_state_dict(model, state_dict)
    if isinstance(target, TrainState):
        saved = torch.load(Path(directory) / tag / STATE_FILE, map_location="cpu",
                           weights_only=True)
        load_full_optimizer_state(model, target.optimizer, saved["optimizer"])
        target.optimizer.notfinite_count = int(saved["notfinite_count"])
        generators = saved.get("generators")
        if generators is not None and len(generators) == world_size():
            target.generator.set_state(generators[dist.get_rank()])
        else:
            target.generator.set_state(saved["generator"])
        target.step = int(saved["step"])
    return target


def atomic_write_json(path, payload: dict) -> None:
    """Write JSON through a temporary file and a rename, so that a crash
    never leaves a torn file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _is_resume_dir(d: Path) -> bool:
    return d.is_dir() and re.fullmatch(r"train_state_\d+", d.name) is not None


def find_resume_state(directory) -> Optional[tuple]:
    """Newest fully committed resume state in ``directory`` as ``(tag,
    host_dict)``, or None.

    The loop saves epoch-numbered tags (``train_state_NNNNNN``) and writes
    ``host_state.json`` inside a tag only after its commit, so a kill at
    any point leaves either the new state whole and marked or the previous
    one as the newest marked. Temporary directories (a kill mid-write) and
    numbered directories without the marker (a kill between commit and
    marker) are skipped."""
    candidates = [d for d in Path(directory).glob("train_state_[0-9]*")
                  if _is_resume_dir(d) and (d / HOST_FILE).exists()]
    if not candidates:
        return None
    chosen = max(candidates, key=lambda p: p.name)
    with open(chosen / HOST_FILE) as f:
        return chosen.name, json.load(f)


def prune_resume_states(directory, keep: int = 2) -> None:
    """Delete all but the newest ``keep`` committed resume states, and the
    debris of a killed run: numbered directories without the marker (the
    loop marks before it prunes, so an unmarked one is a dead process's)
    and temporary directories of resume states (resume saves block, so
    none is in flight when this runs)."""
    committed, debris = [], []
    for d in Path(directory).glob("train_state_[0-9]*"):
        if not d.is_dir():
            continue
        if _is_resume_dir(d):
            (committed if (d / HOST_FILE).exists() else debris).append(d)
        elif TMP_MARK in d.name:
            debris.append(d)
    committed.sort()
    for stale in (committed[:-keep] if keep else committed) + debris:
        shutil.rmtree(stale, ignore_errors=True)
