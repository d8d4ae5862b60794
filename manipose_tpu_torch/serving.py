"""Batch inference / serving API of the port.

Port of ``manipose_tpu/serving.py::Predictor``: sequence windowing with
replicate padding (the native windowing core, ``data.native``), a fixed
window batch, the TTA flip and weighted-average
hypothesis aggregation, and weights from a reference ``.pth`` file or a
seeded random init, or from a run directory of the port's training loop.
On the card the trunk's attention and MLP run the port's CUDA kernels. The model computes in ``cfg.model.dtype`` (fp32 or
bf16, with fp32 parameters).

Besides: int8 serving (``quantize``, ``ops/quant.py``), data-parallel
serving over the local cards (``data_parallel``,
:func:`data_parallel_forward`), and the forward as a ``torch.export``
program (:meth:`Predictor.export_program`, :meth:`Predictor.load_program`).

Spans (``utils.profiling``): ``serve.video`` is one ``predict_video``
call (count ``frames``); ``serve.dispatch`` is one batch's start on the
device (counts ``rows``, padding included, and ``valid``), in
``predict_video`` and ``forward_windows`` alike.
"""

from __future__ import annotations

import copy
import io
import itertools
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .config import Config, load_config
from .data.native import gather_windows
from .device import resolve_device
from .drivers.common import instantiate_model
from .eval.engine import flip_poses
from .geometry import h36m_skeleton_17
from .geometry.skeleton import Skeleton
from .models.rmcl import aggregate_hypotheses
from .ops import quant
from .train.checkpoint import tag_weights
from .utils import profiling
from .weights import load_torch_checkpoint

# int8 serves only when the probe measures int8 GEMMs at least this much
# faster than bf16 (beyond measurement noise), as in the JAX package
INT8_MIN_SPEEDUP = 1.05
# an exported program with a symbolic batch is traced at a batch of at
# least 2 windows: torch.export specializes a dimension whose example size
# is 0 or 1
EXPORT_TRACE_MIN_BATCH = 2


class _LazyWindows:
    """Overlapping windows gathered on slice access, so only one batch of
    windows is materialized at a time."""

    def __init__(self, video: np.ndarray, idx: np.ndarray):
        self._video = video
        self._idx = idx

    def __getitem__(self, s) -> np.ndarray:
        return self._video[self._idx[s]]


class ServingForward(nn.Module):
    """The windows-batch forward: the model, score aggregation and the TTA
    flip. (B, L, J, 2) -> (poses (B, L, J, 3), hypotheses, scores), the
    last two None for models without hypotheses."""

    def __init__(self, model: nn.Module, skeleton: Skeleton, rmcl: bool, tta: bool):
        super().__init__()
        self.model = model
        self.skeleton = skeleton
        self.rmcl = rmcl
        self.tta = tta

    def _aggregate(self, pred):
        if self.rmcl:
            hyps, scores = pred
            return aggregate_hypotheses(hyps, scores, "weighted_ave"), hyps, scores
        return pred, None, None

    def forward(self, x: torch.Tensor):
        agg, hyps, scores = self._aggregate(self.model(x))
        if self.tta:
            f_agg, _, _ = self._aggregate(self.model(flip_poses(x, self.skeleton)))
            agg = (agg + flip_poses(f_agg, self.skeleton)) / 2
        return agg, hyps, scores


def local_devices(device: torch.device) -> List[torch.device]:
    """The devices a data-parallel predictor on ``device`` splits over:
    every local card, or the one CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _check_divides(batch: int, n_devices: int) -> None:
    if batch % n_devices:  # not assert: must survive python -O
        raise ValueError(f"batch_size={batch} must divide over {n_devices} devices")


def data_parallel_forward(module: nn.Module, devices: Sequence) -> Callable:
    """Replicate ``module`` onto ``devices`` and return a forward that
    splits each batch into equal shards in order, runs shard i on replica
    i (a card's shard on a stream of its own, the card's input copied
    there), and concatenates the outputs in order on the batch's device.
    The first replica is ``module`` itself when it lies on the first
    device; the others are copies (the same weights). A batch that does
    not divide over the devices raises ``ValueError``."""
    devices = [torch.device(d) for d in devices]
    first = next(itertools.chain(module.parameters(), module.buffers())).device
    replicas = [module if i == 0 and d == first else copy.deepcopy(module).to(d)
                for i, d in enumerate(devices)]
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]

    def forward(x: torch.Tensor):
        _check_divides(x.shape[0], len(devices))

        def run(rep, shard, dev):
            out = rep(shard.to(dev, non_blocking=True))
            return tuple(None if t is None else t.to(x.device, non_blocking=True)
                         for t in out)

        ready = torch.cuda.current_stream(x.device) if x.is_cuda else None
        outs = []
        for rep, dev, stream, shard in zip(replicas, devices, streams,
                                           x.chunk(len(devices))):
            if stream is None:
                outs.append(run(rep, shard, dev))
                continue
            stream.wait_stream(ready)  # the batch is on the card
            with torch.cuda.stream(stream):
                outs.append(run(rep, shard, dev))  # copied back on the stream
            shard.record_stream(stream)
        if ready is not None:
            for stream, out in zip(streams, outs):
                if stream is None:
                    continue
                ready.wait_stream(stream)
                for t in out:
                    if t is not None:  # made on the stream, read on this one
                        t.record_stream(ready)
        return tuple(None if parts[0] is None else torch.cat(parts)
                     for parts in zip(*outs))

    return forward


class Predictor:
    """Lift 2D keypoint videos to 3D poses.

    Args:
      cfg: full Config (the model/data groups define the architecture).
      skeleton: kinematic skeleton (defaults to the 17-joint H36M one).
      state_dict: float weights under the reference names; None draws a
        seeded random init (for testing).
      batch_size: windows per forward call (the last batch is padded).
      tta: average with the flipped input, in the output's dtype.
      quantize: serve with int8 weight+activation trunk products
        (``ops/quant.py``). ``True`` first measures the int8-vs-bf16 GEMM
        rate on the predictor's device (``quant.int8_speedup``, once per
        process and device type) and stays on the float path, with a
        warning, when int8 is not at least 1.05x faster; ``"force"`` skips
        the probe. The float weights are quantized on construction;
        ``self.quantized`` says which path serves.
      data_parallel: split each window batch over the local cards, one
        replica of the model on each (:func:`data_parallel_forward`);
        ``batch_size`` must divide by their count.
      device: "cuda" (the default) or "cpu".

    Under ``model.dtype=bfloat16`` the rMCL model's poses, hypotheses and
    scores are fp32, as in the JAX package; the other models' poses are
    bf16, and numpy has no bf16, so ``predict_video`` returns them as
    float32 arrays holding the exact bf16 values.
    """

    # the int8 probe's ratio by device type, measured once per process
    _int8_probe_cache: Dict[str, float] = {}

    def __init__(
        self,
        cfg: Optional[Config] = None,
        skeleton: Optional[Skeleton] = None,
        state_dict=None,
        batch_size: int = 8,
        tta: bool = True,
        quantize=False,
        data_parallel: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else load_config("config")
        self.skeleton = skeleton if skeleton is not None else h36m_skeleton_17()
        self.seq_len = self.cfg.data.seq_len
        self.batch_size = batch_size
        self.tta = tta
        if quantize and quantize != "force":
            cache = Predictor._int8_probe_cache
            if self.device.type not in cache:
                cache[self.device.type] = float(quant.int8_speedup(device=self.device))
            ratio = cache[self.device.type]
            if ratio < INT8_MIN_SPEEDUP:
                warnings.warn(
                    f"int8 GEMMs are not faster than bf16 on this device "
                    f"(measured ratio {ratio:.2f}); serving stays on the "
                    f"float path. Pass quantize='force' to override.",
                    stacklevel=2,
                )
                quantize = False
        self.quantized = bool(quantize)
        self.model, self.rmcl = instantiate_model(self.cfg, self.skeleton)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        if self.quantized:
            float_state = self.model.state_dict()
            self.model, _ = instantiate_model(self.cfg, self.skeleton, quant=True)
            self.model.load_state_dict(quant.quantize_state_dict(float_state), strict=True)
        self.model.to(self.device).eval()
        self.serving_forward = ServingForward(self.model, self.skeleton, self.rmcl,
                                              self.tta)
        self.data_parallel = bool(data_parallel)
        if self.data_parallel:
            devices = local_devices(self.device)
            _check_divides(batch_size, len(devices))
            self._forward = data_parallel_forward(self.serving_forward, devices)
        else:
            self._forward = self.serving_forward

    # ------------------------------------------------------------------
    @classmethod
    def from_any(cls, checkpoint: str = "", tag: str = "best_val",
                 cfg: Optional[Config] = None, **kw):
        """One loader for every kind of checkpoint: ``*.pth`` -> reference
        weights; any other path -> a run directory of the port's training
        loop (``tag`` selects the tag); "" -> random weights (smoke-test
        mode, with a warning)."""
        checkpoint = str(checkpoint or "")
        if checkpoint.endswith(".pth"):
            return cls(cfg=cfg, state_dict=load_torch_checkpoint(checkpoint), **kw)
        if checkpoint:
            return cls.from_checkpoint(checkpoint, tag=tag, cfg=cfg, **kw)
        warnings.warn(
            "no checkpoint given; using random weights (smoke-test mode)",
            stacklevel=2,
        )
        return cls(cfg=cfg, **kw)

    @classmethod
    def from_checkpoint(cls, directory, tag: str = "best_val",
                        cfg: Optional[Config] = None, **kw):
        """The weights of tag ``tag`` of a run directory the port's training
        loop wrote (``directory/tag/model.pth``). The JAX package's orbax
        directories are refused (``train.checkpoint.tag_weights``). The
        weights are float; ``quantize`` quantizes them after loading, as
        the JAX package's ``from_checkpoint`` does."""
        state_dict = load_torch_checkpoint(tag_weights(directory, tag))
        return cls(cfg=cfg, state_dict=state_dict, **kw)

    def export_program(self, path=None, batch_symbolic: bool = True) -> bytes:
        """The windows-batch forward (model, aggregation, TTA) and its
        weights as a ``torch.export`` program; returns the bytes of
        ``torch.export.save`` and writes them to ``path`` when given.

        The program keeps the port's kernels: K1, K3 and K5 are operators
        (``manipose::attention_dense``, ``attention_packed``,
        ``mlp_forward``) that it records, and they launch when the program
        runs on the card, in a process that has imported
        ``manipose_tpu_torch.ops`` (:meth:`load_program` does). A quantized
        predictor's program holds its int8 weights and ``torch._int_mm``.
        The JAX package exports an XLA twin instead, because Pallas calls
        cannot be serialized.

        With ``batch_symbolic`` the window batch is a symbolic dimension
        ``b >= 1``, traced at ``max(batch_size, 2)`` windows (torch.export
        would specialize an example size of 1): one program serves any
        batch, one window included. Else the batch is fixed at
        ``batch_size``, and any other size fails the program's input check.
        A data-parallel predictor exports one replica's forward.
        """
        b = self.batch_size
        if batch_symbolic:
            b = max(b, EXPORT_TRACE_MIN_BATCH)
        x = torch.zeros((b, self.seq_len, self.skeleton.num_joints, 2),
                        device=self.device)
        dynamic = None
        if batch_symbolic:
            dynamic = {"x": {0: torch.export.Dim("b", min=1)}}
        with torch.no_grad():
            program = torch.export.export(self.serving_forward, (x,),
                                          dynamic_shapes=dynamic, strict=False)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        data = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(data)
        return data

    @staticmethod
    def load_program(path_or_bytes):
        """An :meth:`export_program` artifact as a callable ``f(keypoints
        (B, L, J, 2)) -> (poses, hypotheses, scores)`` of tensors on the
        device the program was exported on (numpy input is moved there;
        hypotheses and scores are None for models without them)."""
        from . import ops  # noqa: F401  (registers the manipose:: operators)

        if isinstance(path_or_bytes, (bytes, bytearray)):
            path_or_bytes = io.BytesIO(bytes(path_or_bytes))
        module = torch.export.load(path_or_bytes).module()
        device = next(itertools.chain(module.parameters(), module.buffers())).device

        def run(x):
            x = torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray)
                                else x, dtype=torch.float32, device=device)
            with torch.no_grad():
                return module(x)

        return run

    def stream(self, stride: int = 1, lookahead: Optional[int] = None):
        """Open a real-time :class:`~manipose_tpu_torch.streaming.StreamingSession`.

        ``session.push(frames)`` feeds live 2D keypoints and returns 3D
        poses as they clear the ``lookahead`` margin (default
        ``seq_len // 2``: center-frame quality from the bidirectional
        trunk; ``0`` is fully causal); ``session.flush()`` drains the
        tail. Each firing push is one window's forward on the predictor's
        device.
        """
        from .streaming import StreamingSession

        return StreamingSession(self, stride=stride, lookahead=lookahead)

    # ------------------------------------------------------------------
    def _dispatch(self, batch: np.ndarray, want_hyps: bool, n_valid: int):
        """Start one batch on the device; returns what ``_harvest`` needs.
        On the card the input goes up from pinned memory and the results
        come back into pinned buffers, both asynchronously, so the device
        runs while the host harvests the previous batch. ``n_valid``: the
        batch's rows that are not padding."""
        with profiling.span("serve.dispatch", rows=len(batch), valid=n_valid):
            x = torch.from_numpy(batch)
            on_cuda = self.device.type == "cuda"
            if on_cuda:
                x = x.pin_memory()
            x = x.to(self.device, non_blocking=True)
            outs = self._forward(x)
            if not want_hyps:
                outs = outs[:1]
            if not on_cuda:
                return outs, None
            host = []
            for t in outs:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.append(buf.copy_(t, non_blocking=True))
            done = torch.cuda.Event()
            done.record()
            return host, done

    @staticmethod
    def _harvest(pending):
        outs, done = pending
        if done is not None:
            done.synchronize()
        # numpy has no bf16: bf16 results widen to fp32 exactly
        return [t.float().numpy() for t in outs]

    def forward_windows(self, windows: np.ndarray) -> np.ndarray:
        """The aggregated poses (W, L, J, 3) of a batch of windows (W, L, J,
        2), as ``predict_video`` computes each batch (TTA included)."""
        windows = np.ascontiguousarray(windows, np.float32)
        with torch.inference_mode():
            return self._harvest(self._dispatch(windows, False, len(windows)))[0]

    def predict_video(
        self,
        keypoints_2d: np.ndarray,
        return_hypotheses: bool = False,
        window_stride: Optional[int] = None,
    ):
        """(N, J, 2) screen-normalized keypoints -> (N, J, 3) 3D poses.

        Windows of ``seq_len`` frames (replicate-padded tail), batched to
        ``batch_size``. With ``return_hypotheses=True`` returns
        ``(poses, hypotheses (W, H, L, J, 3), scores (W, H, L, 1))``, or
        ``(poses, None, None)`` for models without hypotheses.

        ``window_stride=S`` (``1 <= S <= ceil(seq_len / 2)``) is the quality
        mode: overlapping windows advancing S frames, each frame read from
        the window's centre. The default is non-overlapping tiling.
        """
        keypoints_2d = np.asarray(keypoints_2d, np.float32)
        n_frames, j, c = keypoints_2d.shape
        if n_frames == 0:
            raise ValueError("empty keypoint video")
        if j != self.skeleton.num_joints or c != 2:
            raise ValueError(
                f"expected (N, {self.skeleton.num_joints}, 2) keypoints, got "
                f"{keypoints_2d.shape}"
            )
        with profiling.span("serve.video", frames=n_frames):
            seq_len = self.seq_len
            if window_stride is not None:
                lookahead = seq_len // 2
                if not 1 <= window_stride <= seq_len - lookahead:
                    raise ValueError(
                        f"window_stride={window_stride} must be in "
                        f"[1, {seq_len - lookahead}]"
                    )
                n_windows = (n_frames + window_stride - 1) // window_stride
                # window k ends at frame (k+1)*S + lookahead - 1, indices
                # clamped to the video; frames are read from the positions
                # [L - lookahead - S, L - lookahead)
                ends = (np.arange(n_windows, dtype=np.int64) + 1) * window_stride
                ends += lookahead - 1
                idx = np.clip(
                    ends[:, None] + np.arange(-seq_len + 1, 1)[None, :],
                    0, n_frames - 1,
                )
                clips = _LazyWindows(keypoints_2d, idx)
                emit_lo = seq_len - lookahead - window_stride
                emit_hi = emit_lo + window_stride
            else:
                n_windows = max(1, (n_frames + seq_len - 1) // seq_len)
                starts = np.arange(n_windows, dtype=np.int64) * seq_len
                clips = gather_windows([keypoints_2d], np.zeros(n_windows, np.int64),
                                       starts, seq_len)  # (W, L, J, 2)
                emit_lo, emit_hi = 0, seq_len

            want_hyps = return_hypotheses and self.rmcl
            outs, all_hyps, all_scores = [], [], []

            def harvest(pending, n_valid):
                res = self._harvest(pending)
                outs.append(res[0][:n_valid, emit_lo:emit_hi])
                if want_hyps:
                    all_hyps.append(res[1][:n_valid])
                    all_scores.append(res[2][:n_valid])

            # depth-1 pipeline: start the next batch before harvesting the
            # previous one, so the device computes while the host copies
            with torch.inference_mode():
                pending = None
                for b0 in range(0, n_windows, self.batch_size):
                    batch = clips[b0 : b0 + self.batch_size]
                    n_valid = batch.shape[0]
                    if n_valid < self.batch_size:  # pad to the fixed batch
                        pad = np.repeat(batch[-1:], self.batch_size - n_valid, axis=0)
                        batch = np.concatenate([batch, pad], axis=0)
                    started = (self._dispatch(np.ascontiguousarray(batch), want_hyps,
                                              n_valid), n_valid)
                    if pending is not None:
                        harvest(*pending)
                    pending = started
                harvest(*pending)

            poses = np.concatenate(outs, axis=0).reshape(-1, j, 3)[:n_frames]
            if return_hypotheses:
                if not self.rmcl:
                    return poses, None, None
                return poses, np.concatenate(all_hyps), np.concatenate(all_scores)
            return poses
