"""Batched input pipeline feeding fixed-shape batches to the device.

Port of ``manipose_tpu/data/pipeline.py``: a single-process numpy loader
with deterministic per-epoch RNG streams, batches of the full
``batch_size`` with a ``valid`` mask over the padding rows of the last
one, and a background thread that assembles the next batches while the
device computes. ``Batch.pin_memory`` makes a batch's page-locked copy
(in that thread, when ``evaluate`` runs on the card) and
``Batch.to_device`` queues its copy to the card, asynchronously.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from .windowing import PoseSequenceDataset


@dataclasses.dataclass
class Batch:
    pose_2d: np.ndarray  # (B, L, J, 2)
    pose_3d: np.ndarray  # (B, L, J, 3)
    valid: np.ndarray  # (B,) float32; 0 marks padding rows
    # the three arrays as page-locked host tensors, once pin_memory() ran
    pinned: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def batch_size(self) -> int:
        return self.pose_2d.shape[0]

    def pin_memory(self) -> "Batch":
        """This batch with page-locked copies of its arrays, made on the
        calling thread: ``evaluate`` calls it in its prefetch thread, so the
        thread that launches the kernels only queues the copies."""
        if self.pinned is not None:
            return self
        arrays = (self.pose_2d, self.pose_3d, self.valid)
        pinned = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in arrays)
        return dataclasses.replace(self, pinned=pinned)

    def to_device(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(pose_2d, pose_3d, valid) on ``device``. To the card each goes up
        from its pinned copy (made here unless :meth:`pin_memory` made it
        before) with ``non_blocking=True``, so the copy is queued on the
        current stream and the host goes on; torch's pinned-memory
        allocator keeps the pinned copy until the transfer has run."""
        if device.type == "cuda":
            return tuple(t.to(device, non_blocking=True) for t in self.pin_memory().pinned)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (self.pose_2d, self.pose_3d, self.valid))


class SequenceLoader:
    """Deterministic, optionally shuffled, fixed-shape batch iterator."""

    def __init__(
        self,
        dataset: PoseSequenceDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.dataset)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch])
        )
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            valid = np.ones(self.batch_size, np.float32)
            n_pad = self.batch_size - len(idx)
            if n_pad > 0:
                idx = np.concatenate([idx, np.repeat(idx[-1:], n_pad)])
                valid[self.batch_size - n_pad:] = 0.0
            pose_2d, pose_3d = self.dataset.get_batch(idx, rng)
            yield Batch(pose_2d=pose_2d, pose_3d=pose_3d, valid=valid)
        self._epoch += 1


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so that
    host batch assembly overlaps device compute. An exception in the
    producer is raised in the consumer. A consumer that stops early stops
    the producer too: the thread gives up at its next put."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(sentinel)
        except BaseException as exc:  # handed to the consumer, which raises it
            put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
