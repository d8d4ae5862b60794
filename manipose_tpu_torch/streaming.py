"""Real-time streaming inference: bounded-latency sliding-window lifting.

Port of ``manipose_tpu/streaming.py``. A pose service consumes a live
2D-keypoint stream and must emit 3D poses with bounded latency.
:class:`StreamingSession` provides that on top of
:class:`manipose_tpu_torch.serving.Predictor`:

- every pushed frame enters a sliding window of the model's ``seq_len``;
- the prediction for frame ``t`` is emitted once frame ``t + lookahead``
  has arrived, read from a window whose trailing context is the newest
  available frames (``lookahead = seq_len // 2`` reproduces the
  bidirectional model's center-frame quality; ``0`` is fully causal);
- inference fires every ``stride`` frames, so per-frame cost is one
  window forward per ``stride`` emitted frames and worst-case latency is
  ``lookahead + stride - 1`` frames plus one model call.

Each firing push runs the predictor's windows-batch forward (TTA as the
predictor has it) on one window, on the predictor's device, through the
same dispatch and harvest as ``Predictor.predict_video``. So with
``stride=seq_len, lookahead=0`` and a predictor of ``batch_size=1`` a
session reproduces ``predict_video`` exactly (the same non-overlapping
windows and replicate padding, the same one-window forward).

On a data-parallel predictor (``Predictor(data_parallel=True)``) a window
is replicated up to the predictor's batch size, which divides over its
devices, and row 0 is read, as the JAX session does on a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["StreamingSession"]


class StreamingSession:
    """One live stream. Create via :meth:`Predictor.stream`.

    Not thread-safe; one session per stream. Frames are
    ``(num_joints, 2)`` screen-normalized keypoints, the same
    convention as :meth:`Predictor.predict_video`.
    """

    def __init__(
        self,
        predictor,
        stride: int = 1,
        lookahead: Optional[int] = None,
    ):
        seq_len = predictor.seq_len
        if lookahead is None:
            lookahead = seq_len // 2
        if not 0 <= lookahead < seq_len:
            raise ValueError(
                f"lookahead={lookahead} must be in [0, seq_len={seq_len})"
            )
        if not 1 <= stride <= seq_len - lookahead:
            raise ValueError(
                f"stride={stride} must be in [1, seq_len - lookahead = "
                f"{seq_len - lookahead}]: each call emits stride frames "
                "read from positions before the lookahead margin"
            )
        self.predictor = predictor
        self.stride = int(stride)
        self.lookahead = int(lookahead)
        self.seq_len = seq_len
        self._joints = predictor.skeleton.num_joints
        # the last seq_len frames (older frames can never be needed
        # again); frames [0, seq_len) replicate-pad backwards
        self._tail: list[np.ndarray] = []
        self._count = 0  # frames pushed (incl. flush padding)
        self._emitted = 0  # predictions returned so far
        self._flushed = False

    @property
    def latency_frames(self) -> int:
        """Worst-case frames between pushing frame t and receiving its
        prediction (excludes model-call wall time)."""
        return self.lookahead + self.stride - 1

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self._joints, 3), np.float32)

    # ------------------------------------------------------------------
    def _window(self) -> np.ndarray:
        """The current (seq_len, J, 2) window ending at the newest frame,
        left replicate-padded during warmup (the offline path's replicate
        padding, ``data/windowing.py``)."""
        frames = self._tail
        pad = self.seq_len - len(frames)
        if pad > 0:
            frames = [frames[0]] * pad + frames
        return np.stack(frames, axis=0)

    def _drain(self) -> np.ndarray:
        """Run inference while a full stride-block is emittable."""
        out = []
        lo = self.seq_len - self.lookahead - self.stride
        p = self.predictor
        while self._count - self.lookahead - self._emitted >= self.stride:
            window = self._window()[None]  # (1, L, J, 2)
            if p.data_parallel:
                # a batch of one does not divide over the devices
                window = np.broadcast_to(window, (p.batch_size,) + window.shape[1:])
            agg = p.forward_windows(window)  # (B, L, J, 3)
            # flush padding can overshoot: the window end advances in
            # stride steps, so up to stride-1 emitted slots may lie past
            # the real stream; flush trims via n_real
            out.append(agg[0, lo : lo + self.stride])
            self._emitted += self.stride
        if not out:
            return self._empty()
        return np.concatenate(out, axis=0)

    def _ingest(self, frame: np.ndarray) -> None:
        self._tail.append(frame)
        if len(self._tail) > self.seq_len:
            self._tail.pop(0)
        self._count += 1

    # ------------------------------------------------------------------
    def push(self, frames: np.ndarray) -> np.ndarray:
        """Feed ``(n, J, 2)`` (or a single ``(J, 2)``) new frames.

        Returns the ``(k, J, 3)`` predictions that became available:
        possibly none, possibly several stride blocks. Outputs across
        calls concatenate to one prediction per pushed frame, in order.
        """
        if self._flushed:
            raise RuntimeError("session already flushed")
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        n, j, c = frames.shape
        if j != self._joints or c != 2:
            raise ValueError(
                f"expected (n, {self._joints}, 2) frames, got {frames.shape}"
            )
        out = []
        for i in range(n):
            self._ingest(frames[i])
            block = self._drain()
            if block.size:
                out.append(block)
        if not out:
            return self._empty()
        return np.concatenate(out, axis=0)

    def flush(self) -> np.ndarray:
        """End of stream: emit predictions for the trailing frames still
        inside the latency margin, replicate-padding the future with the
        last real frame (the offline tail convention). The session is
        closed afterwards."""
        if self._flushed:
            raise RuntimeError("session already flushed")
        self._flushed = True
        if not self._tail or self._emitted >= self._count:
            return self._empty()
        n_real = self._count
        out = []
        last = self._tail[-1]
        while self._emitted < n_real:
            self._ingest(last)
            block = self._drain()
            if block.size:
                # trim emissions that fall past the real stream
                keep = min(block.shape[0], n_real - (self._emitted - block.shape[0]))
                out.append(block[:keep])
        if not out:
            return self._empty()
        return np.concatenate(out, axis=0)
