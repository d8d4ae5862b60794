"""Toy plotting utilities (``toy_experiment/utils/plot_utils.py`` plus
the Figure 4 / Figure 8 notebook scripts, condensed).

Port of ``manipose_tpu/toy/plots.py``: numpy and matplotlib only, the same
drawing and the same files. matplotlib is imported when a figure is drawn
(:func:`pyplot`, the Agg backend), so the toy package imports without it
and a caller without it gets matplotlib's ImportError at the first figure.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg backend (files, no display)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_predictions(
    distribution,
    x_test: np.ndarray,
    y_test: np.ndarray,
    predictions_dict: Dict[str, np.ndarray],
    save_path,
) -> str:
    """Circle scenario: data + unit circle + model predictions
    (Figure-4 style)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    theta = np.linspace(0, 2 * np.pi, 400)
    r = getattr(distribution, "radius", 1.0)
    ax.plot(r * np.cos(theta), r * np.sin(theta), "k--", lw=0.8,
            label="manifold")
    ax.scatter(y_test[:, 0], y_test[:, 1], s=6, alpha=0.3, label="data")
    for name, preds in predictions_dict.items():
        preds = np.asarray(preds)
        if preds.ndim == 3:  # hypotheses (B, H, >=2)
            for h in range(preds.shape[1]):
                ax.scatter(
                    preds[:, h, 0], preds[:, h, 1], s=6, alpha=0.5,
                    label=f"{name} hyp {h}" if h < 3 else None,
                )
        else:
            ax.scatter(preds[:, 0], preds[:, 1], s=6, alpha=0.6, label=name)
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return str(save_path)


def plot_training_curve(loss_list, val_loss_list, save_path) -> str:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(loss_list, label="train")
    if val_loss_list:
        ax.plot(val_loss_list, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(True)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return str(save_path)


def plot_torus_predictions(
    y_test: np.ndarray,
    predictions_dict: Dict[str, np.ndarray],
    save_path,
    major_radius: float = 2.0,
    minor_radius: float = 1.0,
) -> str:
    """Torus scenario 3D scatter (Figure-8 style, cf. tor-plot.py)."""
    plt = pyplot()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    u = np.linspace(0, 2 * np.pi, 60)
    v = np.linspace(0, 2 * np.pi, 60)
    uu, vv = np.meshgrid(u, v)
    xx = (major_radius + minor_radius * np.cos(vv)) * np.cos(uu)
    yy = (major_radius + minor_radius * np.cos(vv)) * np.sin(uu)
    zz = minor_radius * np.sin(vv)
    ax.plot_surface(xx, yy, zz, rstride=5, cstride=5, color="k",
                    edgecolors="w", alpha=0.08)
    ax.scatter(y_test[:, 0], y_test[:, 1], y_test[:, 2], s=5, alpha=0.3,
               label="data")
    for name, preds in predictions_dict.items():
        preds = np.asarray(preds)
        if preds.ndim == 3:
            preds = preds.reshape(-1, preds.shape[-1])
        ax.scatter(preds[:, 0], preds[:, 1], preds[:, 2], s=5, alpha=0.5,
                   label=name)
    ax.view_init(elev=15, azim=-160)
    ax.legend(fontsize=8)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return str(save_path)
