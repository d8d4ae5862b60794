"""Evaluation engine: hypothesis aggregation, the TTA flip, oracle metrics.

Port of ``manipose_tpu/eval/engine.py``. One eval step runs the forward
pass (both TTA branches), the aggregation, the oracle and pseudo-oracle
selection and the masked error sums on the device; the host loop only
accumulates scalars and stacks outputs. Padding rows of the last batch are
masked through ``valid``.

As in the JAX package, the oracle error is normalized by J once, on the
TTA and the non-TTA path alike (the reference divides the non-TTA oracle
by J twice, ``eval_utils.py:63-64``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..data.pipeline import prefetch
from ..geometry.skeleton import Skeleton
from ..metrics.losses import wta_l2_loss_and_activate_head
from ..models.rmcl import (
    aggregate_hypotheses,
    concat_hyp_and_scores,
    poses_from_hyp_idx,
)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    tta: bool = True
    rmcl: bool = True
    compute_oracle: bool = True
    agg_mode: str = "weighted_ave"


def flip_poses(poses: torch.Tensor, skeleton: Skeleton) -> torch.Tensor:
    """Horizontal flip: negate u/x, swap left and right joints."""
    perm = np.arange(skeleton.num_joints)
    left = np.asarray(skeleton.joints_left)
    right = np.asarray(skeleton.joints_right)
    perm[left] = right
    perm[right] = left
    sign = torch.ones(poses.shape[-1], dtype=poses.dtype, device=poses.device)
    sign[0] = -1.0
    return poses[..., torch.as_tensor(perm, device=poses.device), :] * sign


def make_eval_step(apply_fn: Callable, skeleton: Skeleton, cfg: EvalConfig):
    """The per-batch eval step: step(pose_2d, pose_3d, valid) -> dict of
    device tensors:
      predictions (B, L, J, 3)  aggregated (weighted-average) poses
      sum_jointerr              sum over valid rows of the per-joint errors
      n_valid                   number of valid rows
    and under rMCL: hypotheses, scores; with the oracle also oracle_preds,
    oracle_sum_jointerr and psoracle_sum_jointerr (divided by J).

    ``apply_fn(x)`` is the model's forward in eval mode. The JAX package
    keeps its jitted steps in an LRU (``manipose_tpu/eval/engine.py:53-57,
    154-166``) so that repeated calls do not recompile; eager torch
    compiles nothing, so this step is a plain closure and nothing is
    cached."""

    def step(pose_2d, pose_3d, valid):
        out = {}
        j = pose_3d.shape[-2]
        mask = valid[:, None, None]  # over (B, L, J)

        if cfg.rmcl:
            hyps, scores = apply_fn(pose_2d)
            predictions = aggregate_hypotheses(hyps, scores, cfg.agg_mode)
            if cfg.compute_oracle:
                _, oracle_idx = wta_l2_loss_and_activate_head(hyps, pose_3d)
                oracle_preds = poses_from_hyp_idx(hyps, oracle_idx)
                psoracle_preds = aggregate_hypotheses(hyps, scores, "best_score")
        else:
            predictions = apply_fn(pose_2d)

        if cfg.tta:
            flipped_in = flip_poses(pose_2d, skeleton)
            if cfg.rmcl:
                hyps_f, scores_f = apply_fn(flipped_in)
                preds_f = aggregate_hypotheses(hyps_f, scores_f, cfg.agg_mode)
                if cfg.compute_oracle:
                    # flip the hypotheses back, then select the oracle and
                    # the best-score hypothesis again
                    hyps_fb = flip_poses(hyps_f, skeleton)
                    _, oracle_idx_f = wta_l2_loss_and_activate_head(hyps_fb, pose_3d)
                    oracle_preds = (
                        oracle_preds + poses_from_hyp_idx(hyps_fb, oracle_idx_f)
                    ) / 2
                    psoracle_preds = (
                        psoracle_preds
                        + aggregate_hypotheses(hyps_fb, scores_f, "best_score")
                    ) / 2
            else:
                preds_f = apply_fn(flipped_in)
            predictions = (predictions + flip_poses(preds_f, skeleton)) / 2

        def masked_jointerr_sum(pred):
            # bf16 predictions minus fp32 targets promote to fp32, as in JAX
            err = torch.linalg.vector_norm(pred - pose_3d, dim=-1)  # (B, L, J)
            return torch.sum(err * mask)

        out["predictions"] = predictions
        out["sum_jointerr"] = masked_jointerr_sum(predictions)
        out["n_valid"] = torch.sum(valid)
        if cfg.rmcl:
            out["hypotheses"] = hyps
            out["scores"] = scores
        if cfg.rmcl and cfg.compute_oracle:
            out["oracle_preds"] = oracle_preds
            out["oracle_sum_jointerr"] = masked_jointerr_sum(oracle_preds) / j
            out["psoracle_sum_jointerr"] = masked_jointerr_sum(psoracle_preds) / j
        return out

    return step


def _dispatch(step, batch, device: torch.device, compute_oracle: bool,
              want_hyps: bool):
    """Start one batch on the device: the step, then its error sums and the
    valid rows of its outputs (in mm) queued for the host. To the card the
    copies go into pinned buffers without waiting, and an event marks
    their end; ``_harvest`` waits on it."""
    x, y, valid = batch.to_device(device)
    out = step(x, y, valid)
    keep = int(batch.valid.sum())
    names = ["sum_jointerr"]
    if compute_oracle:
        names += ["oracle_sum_jointerr", "psoracle_sum_jointerr"]
    arrays = {"scalars": torch.stack([out[k] for k in names])}
    if want_hyps:
        arrays["preds"] = concat_hyp_and_scores(out["hypotheses"][:keep] * 1000.0,
                                                out["scores"][:keep])
    else:
        arrays["preds"] = out["predictions"][:keep] * 1000.0
    if compute_oracle:
        arrays["oracle"] = out["oracle_preds"][:keep] * 1000.0
    # numpy has no bf16: bf16 results widen to fp32 exactly
    arrays = {k: v.float() for k, v in arrays.items()}
    if device.type != "cuda":
        return batch, keep, arrays, None
    host = {}
    for k, t in arrays.items():
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k] = buf.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return batch, keep, host, done


def evaluate(
    model: nn.Module,
    loader: Iterable,
    skeleton: Skeleton,
    cfg: EvalConfig,
    return_hyps: bool = False,
):
    """Host loop over a loader of ``Batch``es on the model's device.

    Returns (all_predictions_mm, all_targets, performance_mm) and, with
    oracle metrics, also (oracle_mpjpe_mm, psoracle_mpjpe_mm,
    all_oracle_preds_mm). Predictions are in mm, targets in meters. With
    ``return_hyps`` (rMCL), the predictions are the hypotheses (mm)
    concatenated with their scores, (N, H, L, J, 4). The model runs in
    eval mode (drop-path off) and without autograd, and gets back its
    mode at the end."""
    device = next(model.parameters()).device
    step = make_eval_step(model, skeleton, cfg)
    compute_oracle = cfg.rmcl and cfg.compute_oracle
    want_hyps = return_hyps and cfg.rmcl
    all_preds, all_targets, all_oracle = [], [], []
    sums = np.zeros(3 if compute_oracle else 1)
    n = 0
    seq_len = joints = None

    def harvest(pending):
        """Wait for one dispatched batch's copies and accumulate them: one
        device -> host transfer of its error sums, none per metric."""
        nonlocal n, seq_len, joints
        batch, keep, arrays, done = pending
        if done is not None:
            done.synchronize()
        seq_len, joints = batch.pose_3d.shape[1:3]
        sums[:] += arrays["scalars"].tolist()
        n += keep
        # copied out, so that the pinned buffers return to torch's cache
        all_preds.append(arrays["preds"].numpy().copy())
        all_targets.append(np.asarray(batch.pose_3d[:keep]))
        if compute_oracle:
            all_oracle.append(arrays["oracle"].numpy().copy())

    was_training = model.training
    model.eval()
    try:
        # depth-1 pipeline: batch i + 1 is queued on the device before batch
        # i's results are read, so the device computes while the host
        # harvests; prefetch() assembles (and, for the card, pins) the next
        # windows meanwhile
        batches = (b.pin_memory() for b in loader) if device.type == "cuda" else loader
        with torch.inference_mode():
            pending = None
            for batch in prefetch(batches):
                started = _dispatch(step, batch, device, compute_oracle, want_hyps)
                if pending is not None:
                    harvest(pending)
                pending = started
            if pending is not None:
                harvest(pending)
    finally:
        model.train(was_training)

    if n == 0 or seq_len is None:
        raise ValueError(
            "evaluate() received an empty loader (no windows: check seq_len "
            "against the video lengths and the subject/action filters)"
        )
    performance = float(sums[0]) / (n * seq_len * joints) * 1000.0
    if not compute_oracle:
        return all_preds, all_targets, performance
    oracle_mpjpe = float(sums[1]) / (n * seq_len) * 1000.0
    psoracle_mpjpe = float(sums[2]) / (n * seq_len) * 1000.0
    return all_preds, all_targets, performance, oracle_mpjpe, psoracle_mpjpe, all_oracle
