"""Human3.6M driver of the port: training and the test protocol.

Port of ``manipose_tpu/drivers/h36m.py``. With ``run.train=true`` (the
default) it trains on the train subjects (``train/loop.py``), validating
on ``subjects_val`` (``data.use_valid``) or the test subjects, and tests
the best weights. The test protocol computes, per action and averaged:
MPJPE, MPSSE (sagittal symmetry), MPSCE (segment std), P-MPJPE, MVJPE,
MSE, error variance, segment-length error and, for rMCL, oracle and
pseudo-oracle MPJPE, plus per-bone, per-joint and per-coordinate tables,
all in mm. The metrics run as tensor code on the model's device.

Run it as ``python -m manipose_tpu_torch.drivers.h36m data.data_dir=<dir>``
(add ``device=cpu`` to run on the CPU, ``run.auto_resume=true`` to pick up
a preempted run, ``run.train=false run.checkpoint_model=<.pth>`` or
``run.checkpoint_params=<run dir>/<tag>`` to test weights); the overrides
are those of ``scripts/main_h36m.py``. ``run.viz=true`` then lifts the
``viz`` group's video and draws it into ``<run.output_dir>/figures``
(``viz/driver.py``; the drawing needs matplotlib).
``parallel.data``, ``parallel.model``, ``parallel.pipe`` (the GPipe trunk,
``parallel.maybe_pipelined_apply``) and ``model.attn_impl=ring`` run under
``torchrun --nproc-per-node N`` (N = data x model x pipe; add
``device=cpu`` for gloo CPU ranks): every rank trains and runs the
protocol, the primary rank writes the run's files.

As in the JAX package, the test subjects default to S11 alone
(``run.test_subjects``), as the reference tests.
"""

from __future__ import annotations

import pickle
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..data import Human36mDataset, create_2d_data, read_3d_data
from ..device import resolve_device
from ..eval.engine import EvalConfig, evaluate
from ..metrics import (
    coordwise_error,
    jointwise_error,
    jointwise_mse,
    mean_velocity_error,
    mse_error,
    p_mpjpe,
    sagittal_symmetry,
    sagittal_symmetry_per_bone,
    segments_len_err,
    segments_max_diff_stretch_per_bone,
    segments_max_stretch_per_bone,
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
    create_loader,
    get_subjects_and_actions,
    init_model_params,
    instantiate_model,
    maybe_restore_eval_params,
    rank_output_dir,
)

ALL_TEST_ACTIONS = [
    "walking", "eating", "smoking", "discussion", "directions", "greeting",
    "phoning", "posing", "purchases", "sitting", "sittingdown", "photo",
    "waiting", "walkdog", "walktogether",
]


def fetch_and_prepare_data(cfg: Config):
    """npz -> Human36mDataset and screen-normalized 2D keypoints, with a
    pickle cache of the preprocessed 3D data beside the npz files. The
    cache's name is the port's own, so that the port and the JAX package
    never read each other's pickles."""
    data_dir = Path(cfg.data.data_dir)
    cache = data_dir / (
        f"preproc_data_3d_{cfg.data.dataset}_{cfg.data.joints}_manipose_tpu_torch.pkl"
    )
    if cache.exists():
        with open(cache, "rb") as f:
            dataset = pickle.load(f)
    else:
        dataset = Human36mDataset(
            data_dir / f"data_3d_{cfg.data.dataset}.npz",
            n_joints=cfg.data.joints,
        )
        dataset = read_3d_data(dataset)
        try:
            with open(cache, "wb") as f:
                pickle.dump(dataset, f)
        except OSError:  # a read-only data directory: run without the cache
            pass
    keypoints = create_2d_data(
        data_dir / f"data_2d_{cfg.data.dataset}_{cfg.data.keypoints}.npz",
        dataset,
    )
    return keypoints, dataset


def run_test_protocol(
    model: torch.nn.Module,
    cfg: Config,
    dataset,
    keypoints,
    rmcl: bool,
    output_dir,
    actions: Optional[list] = None,
    logger: Optional[MetricLogger] = None,
):
    """The per-action test table, on the model's device. Returns (errs,
    head): one row per action and the average row last. Each action's
    ``evaluate`` time (host clock, to its last harvest) and valid frames
    go to the logger as ``eval_seconds`` and ``eval_frames``."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    device = next(model.parameters()).device
    skeleton = dataset.skeleton
    logger = logger or MetricLogger()
    if actions is None:
        actions = list(ALL_TEST_ACTIONS)
    test_subjects = list(cfg.run.get("test_subjects", ["S11"]))

    head = ["act", "mpjpe", "sag sym", "seg std", "p-mpjpe", "mvjpe", "mse",
            "err var", "seg err"]
    n_cols = 8
    if rmcl:
        head += ["oracle mpjpe", "pseudo oracle mpjpe"]
        n_cols = 10
    errs = np.zeros([len(actions) + 1, n_cols])

    analytics = {
        k: (
            np.zeros([len(actions) + 1, skeleton.num_bones]),
            ["act", *skeleton.bones_names],
        )
        for k in ["seg_symmetry", "seg_consistency", "seg_max_strech",
                  "seg_max_delta_strech"]
    }
    analytics["cw_err"] = (np.zeros([len(actions) + 1, 3]), ["act", "x", "y", "z"])
    analytics["jw_err"] = (
        np.zeros([len(actions) + 1, skeleton.num_joints]),
        ["act", *skeleton.joints_names],
    )
    all_seg_errs, all_jw_err_var, all_pred_hyps = [], [], []
    eval_cfg = EvalConfig(tta=cfg.train.tta, rmcl=rmcl, compute_oracle=rmcl)
    rng = np.random.default_rng(cfg.run.seed)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    for i, action in enumerate(actions):
        print(f"Assessing action: {action} - [{i + 1}/{len(actions)}]")
        loader = create_loader(
            keypoints, dataset, [action], test_subjects, cfg, train=False
        )
        t0 = time.perf_counter()
        results = evaluate(
            model, loader, skeleton, eval_cfg,
            return_hyps=bool(cfg.viz.hypothesis) and rmcl,
        )
        seconds = time.perf_counter() - t0
        if rmcl:
            preds, targets, mpjpe, o_mpjpe, pso_mpjpe, oracle_preds = results
            errs[i, 8] = o_mpjpe
            errs[i, 9] = pso_mpjpe
            generated = np.concatenate(oracle_preds, axis=0)  # mm, (N, L, J, 3)
            all_pred_hyps.append((np.concatenate(preds, axis=0), targets))
        else:
            preds, targets, mpjpe = results
            generated = np.concatenate(preds, axis=0)
        errs[i, 0] = mpjpe
        target_mm = np.concatenate(targets, axis=0) * 1000.0
        frames = generated.shape[0] * generated.shape[1]
        print(f"  evaluate: {frames} valid frames in {seconds:.3f} s "
              f"({frames / seconds:.1f} frames/s)")
        logger.log({"action": action, "eval_frames": frames,
                    "eval_seconds": seconds}, step=i)

        gen = torch.from_numpy(generated).to(device)
        tgt = torch.from_numpy(target_mm).to(device)
        n_seq, seq_len, j, _ = generated.shape
        # one long sequence for temporal consistency
        gen_flat_time = gen.reshape(1, n_seq * seq_len, j, 3)

        errs[i, 1] = float(
            sagittal_symmetry(gen, skeleton, mode="average", squared=False)
        )
        errs[i, 2] = float(
            segments_time_consistency(gen_flat_time, skeleton, mode="std")
        )
        errs[i, 3] = float(p_mpjpe(gen, tgt))
        errs[i, 4] = float(mean_velocity_error(gen, tgt, squared=False, axis=1))
        mse = float(mse_error(gen, tgt, "average"))
        errs[i, 5] = mse
        errs[i, 6] = mse - float(mpjpe) ** 2
        errs[i, 7] = float(
            segments_len_err(gen, tgt, skeleton, mode="average", signed=False)
        )

        seg_errs = host(segments_len_err(gen, tgt, skeleton, mode="no_agg"))
        rand_idx = rng.integers(0, max(seg_errs.shape[0] - 1, 1), size=1000)
        all_seg_errs.append(seg_errs[rand_idx])

        bw_sym = host(sagittal_symmetry_per_bone(gen, skeleton, "average", squared=False))
        analytics["seg_symmetry"][0][i, list(skeleton.bones_left)] = bw_sym
        analytics["seg_symmetry"][0][i, list(skeleton.bones_right)] = bw_sym
        analytics["seg_consistency"][0][i] = host(
            segments_time_consistency_per_bone(gen_flat_time, skeleton, "std")
        )
        analytics["jw_err"][0][i] = host(jointwise_error(gen, tgt, "average"))
        analytics["cw_err"][0][i] = host(coordwise_error(gen, tgt, "average"))
        jw_mse = host(jointwise_mse(gen, tgt, "average"))
        all_jw_err_var.append(jw_mse - analytics["jw_err"][0][i] ** 2)
        lo, hi = segments_max_stretch_per_bone(gen_flat_time, skeleton)
        analytics["seg_max_strech"][0][i] = host(hi) - host(lo)
        max_delta, _ = segments_max_diff_stretch_per_bone(gen_flat_time, skeleton)
        analytics["seg_max_delta_strech"][0][i] = host(max_delta)

    errs[-1] = np.mean(errs[:-1], axis=0)
    logger.log(
        {
            "best_val_mpjpe": errs[-1, 0],
            "sag_sym": errs[-1, 1],
            "seg_std": errs[-1, 2],
            "val_pmpjpe": errs[-1, 3],
            "val_mvjpe": errs[-1, 4],
            "val_mse": errs[-1, 5],
            "val_err_var": errs[-1, 6],
            "val_mean_seg_err": errs[-1, 7],
            **(
                {
                    "best_val_oracle_mpjpe": errs[-1, 8],
                    "best_val_ps_oracle_mpjpe": errs[-1, 9],
                }
                if rmcl
                else {}
            ),
        },
        step=0,
    )

    action_col = np.array(list(actions) + ["average"])[:, None]
    save_csv_log(
        output_dir,
        head,
        np.hstack([action_col, errs.astype(str)]),
        is_create=True,
        file_name="protocol_1_err",
    )
    for metric_name, (values, a_head) in analytics.items():
        values[-1] = np.mean(values[:-1], axis=0)
        save_csv_log(
            output_dir,
            a_head,
            np.hstack([action_col, values.astype(str)]),
            is_create=True,
            file_name=metric_name,
        )
    np.save(output_dir / "all_seg_errs.npy", np.concatenate(all_seg_errs, axis=0))
    np.save(output_dir / "all_jw_err_var.npy", np.stack(all_jw_err_var, axis=0))
    if all_pred_hyps:
        with open(output_dir / "all_pred_hyps.pkl", "wb") as f:
            pickle.dump(all_pred_hyps, f)
    return errs, head


def main(cfg: Config, logger: Optional[MetricLogger] = None) -> Optional[float]:
    """The driver: data, the model (``run.checkpoint_model``, the seeded
    init, or with ``run.train=false`` a tag of a port run through
    ``run.checkpoint_params``) on ``cfg.device`` (``cuda`` unless set to
    ``cpu``), training with ``run.train=true``, then the test protocol on
    the best weights, and with ``run.viz=true`` the rendering. Returns the
    best validation MPJPE of the training run, or None when nothing was
    trained."""
    device = resolve_device(cfg.get("device", "cuda"))
    mesh = mesh_from_config(cfg, device)  # the run's one mesh, or None
    if is_primary():
        print("==> Using settings:")
        print(cfg.to_yaml())

    output_dir = Path(cfg.run.output_dir) / cfg.run.experiment
    output_dir.mkdir(parents=True, exist_ok=True)

    keypoints, dataset = fetch_and_prepare_data(cfg)
    subjects_split, actions = get_subjects_and_actions(dataset, cfg)
    subjects_train, subjects_val, subjects_test = subjects_split

    model, rmcl = instantiate_model(cfg, dataset.skeleton, mesh=mesh)
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
            train_loader = create_loader(
                keypoints, dataset, actions, subjects_train, cfg, train=True
            )
            valid_loader = create_loader(
                keypoints, dataset, actions,
                subjects_val if cfg.data.use_valid else subjects_test,
                cfg, train=False,
            )
            result = train_loop(net, cfg, dataset.skeleton, train_loader, valid_loader,
                                output_dir, rmcl=rmcl, logger=logger, device=device,
                                mesh=mesh)
            best_valid_mpjpe = result.best_mpjpe  # the model holds the best weights
            logger.save_csv(out_dir)

        if cfg.run.test:
            run_test_protocol(net, cfg, dataset, keypoints, rmcl, out_dir,
                              actions=actions, logger=logger)

        if cfg.run.viz:  # every rank lifts (collectives); one keeps the figure
            from ..viz.driver import render_from_config

            figures = Path(cfg.run.output_dir) / "figures"
            render_from_config(cfg, net, dataset, keypoints, rmcl,
                               figures_dir=figures if out_dir == output_dir
                               else out_dir / "figures")
    return best_valid_mpjpe


if __name__ == "__main__":
    result = main(load_config("config", overrides=sys.argv[1:]))
    if result is not None:
        print(f"best_valid_mpjpe: {result}")
