"""Human3.6M driver of the port: the eval-only test protocol.

Port of ``manipose_tpu/drivers/h36m.py``. The test protocol computes, per
action and averaged: MPJPE, MPSSE (sagittal symmetry), MPSCE (segment
std), P-MPJPE, MVJPE, MSE, error variance, segment-length error and, for
rMCL, oracle and pseudo-oracle MPJPE, plus per-bone, per-joint and
per-coordinate tables, all in mm. The metrics run as tensor code on the
model's device.

Eval only: ``run.train=true``, ``run.viz=true``, ``parallel.pipe > 1`` and
``run.auto_resume`` raise until the training slice ports them. Run it as
``python -m manipose_tpu_torch.drivers.h36m run.train=false
run.checkpoint_model=<.pth> data.data_dir=<dir>`` (add ``device=cpu`` to
run on the CPU); the overrides are those of ``scripts/main_h36m.py``.

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
from ..utils.logging import MetricLogger, save_csv_log
from ..weights import load_torch_checkpoint
from .common import (
    create_loader,
    get_subjects_and_actions,
    init_model_params,
    instantiate_model,
    maybe_restore_eval_params,
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


def _refuse_unported(cfg: Config) -> None:
    unported = {
        "run.train=true (training)": cfg.run.train,
        "run.viz=true (rendering)": cfg.run.viz,
        "run.auto_resume=true (resuming)": cfg.run.get("auto_resume", False),
        "parallel.pipe > 1 (pipeline parallelism)":
            int((cfg.get("parallel") or {}).get("pipe", 1)) > 1,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet: the port's H36M driver runs the "
                "eval-only test protocol (run.train=false); training comes "
                "with the next slice"
            )


def main(cfg: Config, logger: Optional[MetricLogger] = None) -> Optional[float]:
    """The eval-only driver: data, the model (``run.checkpoint_model`` or
    the seeded init) on ``cfg.device`` (``cuda`` unless set to ``cpu``),
    and the test protocol. Returns the best validation MPJPE of a training
    run, which is None here: nothing is trained."""
    _refuse_unported(cfg)
    device = resolve_device(cfg.get("device", "cuda"))
    print("==> Using settings:")
    print(cfg.to_yaml())

    output_dir = Path(cfg.run.output_dir) / cfg.run.experiment
    output_dir.mkdir(parents=True, exist_ok=True)

    keypoints, dataset = fetch_and_prepare_data(cfg)
    _, actions = get_subjects_and_actions(dataset, cfg)

    model, rmcl = instantiate_model(cfg, dataset.skeleton)
    if cfg.run.checkpoint_model:
        model.load_state_dict(load_torch_checkpoint(cfg.run.checkpoint_model), strict=True)
    else:
        model = maybe_restore_eval_params(init_model_params(model, cfg), cfg)
    model.to(device)

    logger = logger or MetricLogger(mlflow_on=cfg.run.mlflow_on)
    if cfg.run.test:
        run_test_protocol(model, cfg, dataset, keypoints, rmcl, output_dir,
                          actions=actions, logger=logger)
    return None


if __name__ == "__main__":
    result = main(load_config("config", overrides=sys.argv[1:]))
    if result is not None:
        print(f"best_valid_mpjpe: {result}")
