"""Batch inference / serving API of the port.

Port of ``manipose_tpu/serving.py::Predictor``: sequence windowing with
replicate padding (the native windowing core, ``data.native``), a fixed
window batch, the TTA flip and weighted-average
hypothesis aggregation, and weights from a reference ``.pth`` file or a
seeded random init. On the card the trunk's attention and MLP run the
port's CUDA kernels. The model computes in ``cfg.model.dtype`` (fp32 or
bf16, with fp32 parameters).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .config import Config, load_config
from .data.native import gather_windows
from .device import resolve_device
from .drivers.common import instantiate_model
from .eval.engine import flip_poses
from .geometry import h36m_skeleton_17
from .geometry.skeleton import Skeleton
from .models.rmcl import aggregate_hypotheses
from .weights import load_torch_checkpoint


class _LazyWindows:
    """Overlapping windows gathered on slice access, so only one batch of
    windows is materialized at a time."""

    def __init__(self, video: np.ndarray, idx: np.ndarray):
        self._video = video
        self._idx = idx

    def __getitem__(self, s) -> np.ndarray:
        return self._video[self._idx[s]]


class Predictor:
    """Lift 2D keypoint videos to 3D poses.

    Args:
      cfg: full Config (the model/data groups define the architecture).
      skeleton: kinematic skeleton (defaults to the 17-joint H36M one).
      state_dict: weights under the reference names; None draws a seeded
        random init (for testing).
      batch_size: windows per forward call (the last batch is padded).
      tta: average with the flipped input, in the output's dtype.
      device: "cuda" (the default) or "cpu".

    Under ``model.dtype=bfloat16`` the rMCL model's poses, hypotheses and
    scores are fp32, as in the JAX package; the other models' poses are
    bf16, and numpy has no bf16, so ``predict_video`` returns them as
    float32 arrays holding the exact bf16 values.

    ``quantize`` and ``data_parallel`` are not ported yet and raise.
    """

    def __init__(
        self,
        cfg: Optional[Config] = None,
        skeleton: Optional[Skeleton] = None,
        state_dict=None,
        batch_size: int = 8,
        tta: bool = True,
        quantize: bool = False,
        data_parallel: bool = False,
        device="cuda",
    ):
        if quantize:
            raise NotImplementedError("int8 serving (quantize) is not ported yet")
        if data_parallel:
            raise NotImplementedError("data_parallel serving is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else load_config("config")
        self.skeleton = skeleton if skeleton is not None else h36m_skeleton_17()
        self.seq_len = self.cfg.data.seq_len
        self.batch_size = batch_size
        self.tta = tta
        self.model, self.rmcl = instantiate_model(self.cfg, self.skeleton)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self._forward = self._make_forward(self.model)

    def _make_forward(self, model):
        """Windows-batch forward: model + score aggregation + TTA flip."""
        skeleton = self.skeleton

        def aggregate(pred):
            if self.rmcl:
                hyps, scores = pred
                return aggregate_hypotheses(hyps, scores, "weighted_ave"), hyps, scores
            return pred, None, None

        def forward(x):
            agg, hyps, scores = aggregate(model(x))
            if self.tta:
                f_agg, _, _ = aggregate(model(flip_poses(x, skeleton)))
                agg = (agg + flip_poses(f_agg, skeleton)) / 2
            return agg, hyps, scores

        return forward

    # ------------------------------------------------------------------
    @classmethod
    def from_any(cls, checkpoint: str = "", tag: str = "best_val",
                 cfg: Optional[Config] = None, **kw):
        """``*.pth`` -> reference weights; "" -> random weights (smoke-test
        mode, with a warning). Orbax run directories (``tag`` selects the
        best-tag subtree in the JAX package) wait for the training slice."""
        checkpoint = str(checkpoint or "")
        if checkpoint.endswith(".pth"):
            return cls(cfg=cfg, state_dict=load_torch_checkpoint(checkpoint), **kw)
        if checkpoint:
            raise NotImplementedError(
                f"orbax checkpoints ({checkpoint}, tag {tag}) are not ported "
                "yet; pass a reference .pth file"
            )
        warnings.warn(
            "no checkpoint given; using random weights (smoke-test mode)",
            stacklevel=2,
        )
        return cls(cfg=cfg, **kw)

    def export_stablehlo(self, *args, **kwargs):
        raise NotImplementedError("export (torch.export) is not ported yet")

    def stream(self, *args, **kwargs):
        raise NotImplementedError("streaming sessions are not ported yet")

    # ------------------------------------------------------------------
    def _dispatch(self, batch: np.ndarray, want_hyps: bool):
        """Start one batch on the device; returns what ``_harvest`` needs.
        On the card the input goes up from pinned memory and the results
        come back into pinned buffers, both asynchronously, so the device
        runs while the host harvests the previous batch."""
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
                started = (self._dispatch(np.ascontiguousarray(batch), want_hyps),
                           n_valid)
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
