"""MPI-INF-3DHP driver of the port: training and the PCK/AUC test protocol.

Port of ``manipose_tpu/drivers/dhp3.py``. With ``run.train=true`` (the
default) it trains on the train archive (``train/loop.py``), validating on
the test archive, and tests the best weights. The test protocol keeps the
reference's semantics:
- with rMCL, the headline PCK and AUC are computed on the *oracle* poses
  and ``agg_pck`` / ``agg_auc`` on the score-aggregated ones;
- the scalar MPSCE flattens all eval windows into one long sequence while
  the per-bone MPSCE stays per window (the reference's inconsistency, kept).
The metrics run as tensor code on the model's device.

Run it as ``python -m manipose_tpu_torch.drivers.dhp3 data.data_dir=<dir>``
(the ``data=mpi_inf_3dhp`` group is inserted when no ``data=`` or
``data.dataset=`` override is given; add ``device=cpu`` to run on the CPU,
``run.auto_resume=true`` to pick up a preempted run,
``run.train=false run.checkpoint_model=<.pth>`` or
``run.checkpoint_params=<run dir>/<tag>`` to test weights); the overrides
are those of ``scripts/main_3dhp.py``. ``parallel.data``,
``parallel.model``, ``parallel.pipe`` (the GPipe trunk) and
``model.attn_impl=ring`` run under ``torchrun --nproc-per-node N`` (N =
data x model x pipe; add ``device=cpu`` for gloo CPU ranks): every rank
trains and runs the protocol, the primary rank writes the run's files.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..data import PoseSequenceDataset, SequenceLoader
from ..data.dhp3 import Dataset3DHP
from ..device import resolve_device
from ..eval.engine import EvalConfig, evaluate
from ..metrics import (
    coordwise_error,
    jointwise_error,
    keypoint_3d_auc,
    keypoint_3d_pck,
    sagittal_symmetry,
    sagittal_symmetry_per_bone,
    segments_time_consistency,
    segments_time_consistency_per_bone,
)
from ..parallel.flagship import maybe_pipelined_apply
from ..parallel.mesh import mesh_from_config
from ..parallel.multihost import is_primary
from ..train.loop import train as train_loop
from ..utils.logging import MetricLogger, save_csv_log
from ..weights import load_torch_checkpoint
from .common import (
    init_model_params,
    instantiate_model,
    maybe_restore_eval_params,
    rank_output_dir,
)

PCK_THRESHOLD_MM = 150.0


def create_loader(dataset: Dataset3DHP, cfg: Config, train: bool = True) -> SequenceLoader:
    """Windows of ``cfg.data.seq_len`` frames of every sequence: random
    starts, flips and shuffling at train time, sequential otherwise (the
    last short window of a sequence dropped, as in the JAX package)."""
    ds = PoseSequenceDataset(
        dataset.poses,
        dataset.poses_2d,
        None,
        seq_len=cfg.data.seq_len,
        random_start=train,
        miss_type=cfg.data.miss_type,
        miss_rate=cfg.data.miss_rate,
        noise_sigma=cfg.data.noise_sigma,
        skeleton=dataset.skeleton,
        flip_probability=0.5 if (train and cfg.train.flip_aug) else 0.0,
    )
    return SequenceLoader(
        ds,
        batch_size=cfg.train.batch_size if train else cfg.train.batch_size_test,
        shuffle=train,
        seed=cfg.run.seed,
    )


def run_test_protocol(
    model: torch.nn.Module,
    cfg: Config,
    dataset: Dataset3DHP,
    rmcl: bool,
    output_dir,
    logger: Optional[MetricLogger] = None,
    return_predictions: bool = False,
):
    """PCK@150 mm, AUC, MPJPE, MPSSE and MPSCE of the test archive on the
    model's device, the four analytics CSVs and ``test_metrics.csv``.
    ``evaluate``'s time (host clock, to its last harvest) and valid frames
    go to the logger as ``eval_seconds`` and ``eval_frames``. Returns the
    metrics, and with ``return_predictions`` also the predictions of its
    ``evaluate`` (windows, L, J, 3), in mm: under rMCL the aggregated poses
    (``agg_pck``'s), which do not depend on the targets."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    skeleton = dataset.skeleton
    logger = logger or MetricLogger()
    loader = create_loader(dataset, cfg, train=False)
    eval_cfg = EvalConfig(tta=cfg.train.tta, rmcl=rmcl, compute_oracle=rmcl)

    t0 = time.perf_counter()
    results = evaluate(model, loader, skeleton, eval_cfg)
    seconds = time.perf_counter() - t0
    metrics = {}
    if rmcl:
        agg_preds, targets, mpjpe, o_mpjpe, pso_mpjpe, oracle_preds = results
        generated = np.concatenate(oracle_preds, axis=0)  # mm
        aggregated = np.concatenate(agg_preds, axis=0)  # mm
        metrics["best_val_oracle_mpjpe"] = o_mpjpe
        metrics["best_val_ps_oracle_mpjpe"] = pso_mpjpe
    else:
        preds, targets, mpjpe = results
        generated = np.concatenate(preds, axis=0)
        aggregated = None
    target_mm = np.concatenate(targets, axis=0) * 1000.0
    metrics["best_val_mpjpe"] = mpjpe
    frames = generated.shape[0] * generated.shape[1]
    print(f"  evaluate: {frames} valid frames in {seconds:.3f} s "
          f"({frames / seconds:.1f} frames/s)")
    logger.log({"eval_frames": frames, "eval_seconds": seconds}, step=0)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    gen = torch.from_numpy(generated).to(device)
    tgt = torch.from_numpy(target_mm).to(device)
    n_seq, seq_len, j, _ = generated.shape
    gen_flat_time = gen.reshape(1, n_seq * seq_len, j, 3)
    tgt_joints = tgt.reshape(-1, j, 3)

    metrics["sag_sym"] = float(
        sagittal_symmetry(gen, skeleton, mode="average", squared=False)
    )
    metrics["seg_std"] = float(
        segments_time_consistency(gen_flat_time, skeleton, mode="std")
    )
    metrics["pck"] = float(keypoint_3d_pck(gen.reshape(-1, j, 3), tgt_joints, mask=None,
                                           threshold=PCK_THRESHOLD_MM))
    metrics["auc"] = float(keypoint_3d_auc(gen.reshape(-1, j, 3), tgt_joints, mask=None))
    if rmcl:
        agg = torch.from_numpy(aggregated).to(device).reshape(-1, j, 3)
        metrics["agg_pck"] = float(keypoint_3d_pck(agg, tgt_joints, mask=None,
                                                   threshold=PCK_THRESHOLD_MM))
        metrics["agg_auc"] = float(keypoint_3d_auc(agg, tgt_joints, mask=None))

    # the analytics CSVs (``main_3dhp.py:769-792,826-878,988``)
    analytics = {}
    bw_sym = host(sagittal_symmetry_per_bone(gen, skeleton, "average", squared=False))
    seg_symmetry = np.zeros([1, skeleton.num_bones])
    seg_symmetry[0, list(skeleton.bones_left)] = bw_sym
    seg_symmetry[0, list(skeleton.bones_right)] = bw_sym
    analytics["seg_symmetry"] = (seg_symmetry, list(skeleton.bones_names))
    analytics["seg_consistency"] = (
        host(segments_time_consistency_per_bone(gen, skeleton, "std"))[None],
        list(skeleton.bones_names),
    )
    analytics["jw_err"] = (
        host(jointwise_error(gen, tgt, "average"))[None],
        list(skeleton.joints_names),
    )
    analytics["cw_err"] = (host(coordwise_error(gen, tgt, "average"))[None], ["x", "y", "z"])
    for name, (values, head) in analytics.items():
        save_csv_log(output_dir, head, values.astype(str), is_create=True, file_name=name)
    logger.log(metrics, step=0)
    # the headline metrics get a CSV of their own, as the reference writes
    # them at the end of its test block (``main_3dhp.py:931-988``): an
    # eval-only run writes no metrics.csv
    head = list(metrics.keys())
    save_csv_log(
        output_dir,
        head,
        np.asarray([[repr(float(metrics[k])) for k in head]]),
        is_create=True,
        file_name="test_metrics",
    )
    print("==> 3DHP test metrics:")
    for k in head:
        print(f"    {k}: {float(metrics[k]):.4f}")
    if return_predictions:
        return metrics, generated if aggregated is None else aggregated
    return metrics


def main(cfg: Config, logger: Optional[MetricLogger] = None) -> Optional[float]:
    """The driver: the 3DHP archives, the model (``run.checkpoint_model``,
    the seeded init, or with ``run.train=false`` a tag of a port run through
    ``run.checkpoint_params``) on ``cfg.device`` (``cuda`` unless set to
    ``cpu``), training with ``run.train=true``, then the test protocol on
    the best weights. Returns the best validation MPJPE of the training
    run, or None when nothing was trained."""
    if cfg.data.dataset != "3dhp":
        raise ValueError("use the data=mpi_inf_3dhp group for the 3DHP driver")
    device = resolve_device(cfg.get("device", "cuda"))
    mesh = mesh_from_config(cfg, device)  # the run's one mesh, or None
    if is_primary():
        print("==> Using settings:")
        print(cfg.to_yaml())
    output_dir = Path(cfg.run.output_dir) / cfg.run.experiment
    output_dir.mkdir(parents=True, exist_ok=True)

    dataset_train = Dataset3DHP(cfg.data.data_dir, train=True) if cfg.run.train else None
    dataset_test = Dataset3DHP(cfg.data.data_dir, train=False) if cfg.run.test else None
    skeleton = (dataset_test or dataset_train).skeleton

    model, rmcl = instantiate_model(cfg, skeleton, mesh=mesh)
    if cfg.run.checkpoint_model:
        model.load_state_dict(load_torch_checkpoint(cfg.run.checkpoint_model), strict=True)
    else:
        model = maybe_restore_eval_params(init_model_params(model, cfg), cfg)
    model.to(device)
    # parallel.pipe > 1: the GPipe-staged trunk, for training and the protocol
    net = maybe_pipelined_apply(model, cfg, mesh)

    logger = logger or MetricLogger(mlflow_on=cfg.run.mlflow_on,
                                    experiment=cfg.run.experiment)
    best_valid_mpjpe = None
    with rank_output_dir(output_dir) as out_dir:
        if cfg.run.train:
            train_loader = create_loader(dataset_train, cfg, train=True)
            valid_loader = create_loader(
                dataset_test if dataset_test is not None
                else Dataset3DHP(cfg.data.data_dir, train=False),
                cfg, train=False,
            )
            result = train_loop(net, cfg, skeleton, train_loader, valid_loader,
                                output_dir, rmcl=rmcl, logger=logger, device=device,
                                mesh=mesh)
            best_valid_mpjpe = result.best_mpjpe  # the model holds the best weights
            logger.save_csv(out_dir)

        if cfg.run.test:
            run_test_protocol(net, cfg, dataset_test, rmcl, out_dir, logger=logger)
    return best_valid_mpjpe


def overrides_with_data_group(argv) -> list:
    """``argv`` with ``data=mpi_inf_3dhp`` in front unless it names a data
    group or dataset itself (``scripts/main_3dhp.py:22-25``)."""
    overrides = list(argv)
    if not any(o.startswith(("data=", "data.dataset=")) for o in overrides):
        overrides.insert(0, "data=mpi_inf_3dhp")
    return overrides


if __name__ == "__main__":
    result = main(load_config("config", overrides=overrides_with_data_group(sys.argv[1:])))
    if result is not None:
        print(f"best_valid_mpjpe: {result}")
