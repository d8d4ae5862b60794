"""Toy experiment driver (``toy_experiment/main.py``): the paper's Table 1
(circle scenarios) and Table 6 (torus 2D->3D).

Port of ``manipose_tpu/toy/main.py``, reading ``configs/toy.yaml`` and its
groups unchanged::

    python -m manipose_tpu_torch.toy.main data.scenario=hard-2 \\
        model.arch=constrained_rmcl [device=cpu]

It runs on the card unless ``device=cpu`` is given. The model starts from
flax's default init drawn from ``run.seed`` (``toy/models.py``), or from
the ``state_dict`` the caller passes (the tests pass the JAX package's
init, carried across by ``weights.toy_state_dict_from_jax``). It writes
``train_loss.npy``, ``test_predictions.npy``, ``test_hypotheses.npy``
(multi-hypothesis models) and ``metrics.txt`` under
``run.output_dir/run.experiment``.

With ``run.plots=true`` (a port key: the JAX main always draws) it also
draws the JAX main's ``predictions_plot.png`` and ``training.png``
(``toy/plots.py``; matplotlib, which must be installed then).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import Config, load_config
from .datasets import LiftingDataset, LiftingDatasetV2
from .diffusion import LiftingDiffusionModel
from .distributions import (
    EasyDist,
    HardBimodalDist,
    HardQuadmodalDist,
    HardUnimodalDist,
    torus_scenario,
)
from .metrics import calc_mpjpe, calc_mpjpe_3d, distance_to_circle, std_length
from .models import (
    ACTIVATIONS,
    ConstrainedMlp,
    ConstrainedMlpRmcl,
    ConstrainedMlpRmclV2,
    ConstrainedMlpV2,
    ToyMlp,
    init_toy_model,
)
from .trainer import ToyTrainer, ToyTrainerConfig


def build_distribution(cfg: Config):
    """(``toy_experiment/main.py:49-81``)"""
    scenario = cfg.data.scenario
    if scenario == "easy":
        return EasyDist(cfg.data.radius, cfg.run.seed)
    if scenario == "hard-1":
        return HardUnimodalDist(cfg.data.radius, cfg.run.seed)
    if scenario == "hard-2":
        return HardBimodalDist(cfg.data.radius, cfg.run.seed)
    if scenario == "hard-4":
        return HardQuadmodalDist(cfg.data.radius, cfg.run.seed)
    if scenario == "torus-2Dto3D":
        return torus_scenario(cfg.data.major_radius, cfg.data.minor_radius, cfg.run.seed)
    raise ValueError(
        "Possible values for scenario are 'easy', 'hard-1', 'hard-2', "
        f"'hard-4' or 'torus-2Dto3D'. Got {scenario}."
    )


def build_model(cfg: Config, enabled_3d: bool):
    """(``toy_experiment/main.py:105-194``). Returns (model, kind,
    joints_prediction); inputs are 2D in the torus scenario, else 1D."""
    act = ACTIVATIONS[cfg.model.act]
    m = cfg.model
    in_features = 2 if enabled_3d else 1
    if cfg.diffusion.enabled and enabled_3d:
        # the denoiser predicts 2D targets (reference diffusion.py:38-45)
        raise NotImplementedError(
            "The diffusion baseline only supports the 1D->2D circle "
            "scenarios (its denoiser predicts 2D targets)."
        )
    if cfg.diffusion.enabled:
        model = LiftingDiffusionModel(
            in_features=in_features, hidden_features=m.hidden_features,
            n_layers=m.layers, num_steps=cfg.diffusion.num_steps,
            schedule=cfg.diffusion.schedule, beta_start=cfg.diffusion.beta_start,
            beta_end=cfg.diffusion.beta_end, n_samples=cfg.multi_hyp.nsamples, act=act,
        )
        return model, "diffusion", False
    if m.arch == "mlp":
        return (ToyMlp(in_features, m.hidden_features, 6 if enabled_3d else 2, m.layers,
                       act), "plain", True)
    if m.arch == "constrained":
        if enabled_3d:
            return (ConstrainedMlpV2(in_features, m.hidden_features, m.layers, act,
                                     cfg.data.major_radius, cfg.data.minor_radius),
                    "plain", False)
        return (ConstrainedMlp(in_features, m.hidden_features, m.layers, act,
                               cfg.data.radius), "plain", False)
    if m.arch == "constrained_rmcl":
        if enabled_3d:
            return (ConstrainedMlpRmclV2(in_features, m.hidden_features, m.layers, act,
                                         cfg.data.major_radius, cfg.data.minor_radius,
                                         n_hyp=cfg.multi_hyp.nsamples, beta=m.beta),
                    "mcl", False)
        return (ConstrainedMlpRmcl(in_features, m.hidden_features, m.layers, act,
                                   cfg.data.radius, n_hyp=cfg.multi_hyp.nsamples,
                                   beta=m.beta), "mcl", False)
    raise ValueError(f"Unknown toy arch: {m.arch}")


def main(cfg: Config, state_dict: Optional[dict] = None) -> Optional[float]:
    """Train and test as ``cfg`` says on ``cfg.device`` (the card unless
    ``cpu``); returns the validation MPJPE (None without ``run.test``)."""
    print("==> Using settings:")
    print(cfg.to_yaml())
    output_dir = Path(cfg.run.output_dir) / cfg.run.experiment
    output_dir.mkdir(parents=True, exist_ok=True)

    enabled_3d = "3D" in cfg.data.scenario
    distribution = build_distribution(cfg)
    ds_cls = LiftingDatasetV2 if enabled_3d else LiftingDataset
    data = ds_cls(distribution, cfg.data.n_train, cfg.data.n_val, cfg.data.n_test)

    model, kind, joints_prediction = build_model(cfg, enabled_3d)
    init_toy_model(model, cfg.run.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    trainer = ToyTrainer(
        model,
        ToyTrainerConfig(
            epochs=cfg.train.epochs, batch_size=cfg.train.batch_size, lr=cfg.train.lr,
            lr_scheduler=cfg.train.lr_scheduler, lr_min=cfg.train.lr_min,
            lr_patience=cfg.train.lr_patience, lr_threshold=cfg.train.lr_threshold,
            seed=cfg.run.seed,
        ),
        model_kind=kind,
        enabled_3d=enabled_3d,
        joints_prediction=joints_prediction,
        beta=cfg.model.beta,
        major_radius=cfg.data.get("major_radius", 2.0),
        minor_radius=cfg.data.get("minor_radius", 1.0),
        device=cfg.get("device", "cuda"),
    )

    metrics = {}
    if cfg.run.train:
        trainer.train(data.train, val_data=data.val)
        np.save(output_dir / "train_loss.npy", np.asarray(trainer.loss_list))

    if cfg.run.test:
        if enabled_3d:
            mr, nr = cfg.data.major_radius, cfg.data.minor_radius
            (val_mpjpe, test_mpjpe), (_, test_predictions), hyps = trainer.evaluate(
                [data.val, data.test],
                lambda p, y: calc_mpjpe_3d(
                    p, y, joints_predictions=joints_prediction and kind == "plain",
                    major_radius=mr, minor_radius=nr),
            )
            if kind == "plain" and joints_prediction:
                sl = std_length(test_predictions, joint_prediction=True,
                                major_radius=mr, minor_radius=nr)
            elif kind == "mcl":
                # consistency over the raw hypotheses (std_length(mcl_version=True))
                sl = std_length(hyps[1], mcl_version=True, major_radius=mr,
                                minor_radius=nr)
            else:
                sl = std_length(test_predictions, major_radius=mr, minor_radius=nr)
            metrics = {"val_mpjpe": val_mpjpe, "test_mpjpe": test_mpjpe,
                       "std_length_joint": sl}
        else:
            (val_mpjpe, test_mpjpe), (_, test_predictions), hyps = trainer.evaluate(
                [data.val, data.test], calc_mpjpe)
            (val_dtc, test_dtc), _, _ = trainer.evaluate([data.val, data.test],
                                                         distance_to_circle)
            metrics = {"val_mpjpe": val_mpjpe, "test_mpjpe": test_mpjpe,
                       "val_dtc": val_dtc, "test_dtc": test_dtc}
        np.save(output_dir / "test_predictions.npy", np.asarray(test_predictions))
        if hyps is not None:
            np.save(output_dir / "test_hypotheses.npy", np.asarray(hyps[1]))
        with open(output_dir / "metrics.txt", "w") as f:
            for k, v in metrics.items():
                f.write(f"{k}: {v}\n")
        print("\n".join(f"{k}: {v}" for k, v in metrics.items()))
        if cfg.run.get("plots", False):
            # the JAX main's plots (manipose_tpu/toy/main.py:220-242)
            from .plots import plot_predictions, plot_torus_predictions, plot_training_curve

            if enabled_3d:
                plot_torus_predictions(
                    data.y_test, {cfg.model.arch: test_predictions},
                    output_dir / "predictions_plot.png",
                    major_radius=cfg.data.major_radius,
                    minor_radius=cfg.data.minor_radius,
                )
            else:
                plot_predictions(
                    distribution, data.x_test, data.y_test,
                    {cfg.model.arch: test_predictions},
                    output_dir / "predictions_plot.png",
                )
            plot_training_curve(trainer.loss_list, trainer.val_loss_list,
                                output_dir / "training.png")
    return metrics.get("val_mpjpe")


if __name__ == "__main__":
    main(load_config("toy", overrides=sys.argv[1:]))
