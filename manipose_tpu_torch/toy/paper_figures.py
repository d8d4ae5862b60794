"""Paper-figure reproduction for the toy experiments.

Port of ``manipose_tpu/toy/paper_figures.py``: the drawing is the JAX
package's (numpy and matplotlib, copied here, as the port imports nothing
of it) and writes the same files; the figure models train on the port's
``ToyTrainer`` on ``device`` (the card unless the caller asks for the
CPU).

Figure 4 (``toy_experiment/plotting_script.py``): a 2x2 panel — (A) the
1D->2D lifting setting sketch, (B) Euclidean-vs-manifold oracle
minimizers with trained point-prediction models on hard-2, (C)/(D) model
predictions + ManiPose hypotheses with score rays on hard-2 and hard-4.

Figure 8 (``toy_experiment/tor-plot.py``): the torus mixture's samples on
a wireframe torus, colored by mixture component.

matplotlib is imported when a figure is drawn (``plots.pyplot``), so
:func:`train_figure_models` runs where matplotlib is absent.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .plots import pyplot

# reference palette roles (plotting_script.py METHODS_COLORS region)
INP_COL = "#4878d0"   # inputs
GT_COL = "#6acc64"    # ground truth / density
MLP_COL = "#d65f5f"   # unconstrained MLP
CONST_COL = "#956cb4"  # constrained MLP
MANI_COL = "#d5bb67"  # ManiPose / manifold objects

METHODS_NAMES = {
    "mlp": "Unconstr. MLP",
    "constrained": "Constr. MLP",
    "constrained_rmcl": "ManiPose",
}
METHODS_COLORS = {
    "mlp": MLP_COL,
    "constrained": CONST_COL,
    "constrained_rmcl": MANI_COL,
}
_HYP_MARKERS = ["s", "^", "v", "D", "P"]


def _polar2cartesian(r, theta):
    return np.asarray([r * np.cos(theta), r * np.sin(theta)])


# ---------------------------------------------------------------------------
# circle scaffolding (``utils/plot_utils.py:50-209``)
# ---------------------------------------------------------------------------
def plot_circle(r=1.0, ax=None, show_center=False, show_input_ax=True,
                show_input_ax_label=False, inputs_offset=2.0,
                show_output_axs=False):
    theta = np.linspace(0, 2 * np.pi, 500, endpoint=False)
    x, y = _polar2cartesian(r, theta)
    if ax is None:
        ax = pyplot().gca()
    ax.plot(x, y, color="grey", lw=2, zorder=0, ls="--")
    ax.set_aspect("equal")
    ax.axis("off")
    if show_center:
        ax.scatter(0, 0, marker="+", s=50, color="black")
    if show_input_ax:
        ax.arrow(-1.2 * r, -inputs_offset, 2.4 * r, 0.0, width=0.01,
                 head_width=0.1, facecolor="black")
        if show_input_ax_label:
            ax.text(1.2 * r, -0.2 * r - inputs_offset, s="x")
    if show_output_axs:
        ax.arrow(0.0, 0.0, 1.2 * r, 0.0, width=0.01, head_width=0.1,
                 facecolor="black")
        ax.text(1.2 * r, -0.2 * r, s="x")
        ax.arrow(0.0, 0.0, 0.0, 1.2 * r, width=0.01, head_width=0.1,
                 facecolor="black")
        ax.text(-0.2 * r, 1.2 * r, s="y")
    return ax


def plot_angular_density(theta, pdf, r=1.0, colour=GT_COL, ax=None,
                         show_center=False, label=None, inputs_offset=2.0):
    ax = plot_circle(r=r, ax=ax, show_center=show_center,
                     inputs_offset=inputs_offset)
    xi, yi = _polar2cartesian(r + pdf, theta)
    ax.plot(xi, yi, color=colour, lw=2, label=label, zorder=1)
    return ax


# ---------------------------------------------------------------------------
# Figure 4 panels
# ---------------------------------------------------------------------------
def plot_setting(radius=1.0, offset=2.0, ax=None, display_legend=True,
                 show_angle=True):
    """Panel (A): the lifting setting sketch
    (``plotting_script.py:92-163``)."""
    from matplotlib.patches import Arc

    ax = plot_circle(r=radius, ax=ax, show_input_ax=True,
                     show_input_ax_label=True, inputs_offset=offset,
                     show_output_axs=True)
    ang = np.pi / 3
    x_pos, y_pos = np.cos(ang), np.sin(ang)
    ax.scatter(0.0, -offset, marker="o", s=50, color=INP_COL, label="Inputs")
    ax.text(0.1, -offset + 0.1, s="K0")
    ax.scatter(x_pos, -offset, marker="o", s=50, color=INP_COL)
    ax.text(x_pos + 0.1, -offset + 0.1, s="K1")
    ax.scatter(0.0, 0.0, marker="o", s=50, color=GT_COL, label="Outputs")
    ax.text(-0.2, 0.1, s="J0")
    ax.scatter(x_pos, y_pos, marker="o", s=50, color=GT_COL)
    ax.text(x_pos, y_pos + 0.2, s="J1")
    ax.plot([0.0, x_pos], [0.0, y_pos], "k-", lw=2, zorder=0)
    ax.text(x_pos / 2 - 0.15, y_pos / 2, s=r"$s$")
    ax.vlines(x=[0.0, x_pos], ymin=[-offset] * 2, ymax=[0.0, y_pos],
              ls="--", lw=1.5, color="grey", zorder=0)
    if show_angle:
        ax.add_patch(Arc((0.0, 0.0), 0.5 * radius, 0.5 * radius, angle=0.0,
                         theta1=0.0, theta2=np.degrees(ang), color="grey",
                         linewidth=1.5))
        ax.text(0.3 * radius, 0.1 * radius, r"$\theta$")
    if display_legend:
        ax.legend(loc="lower left")
    return ax


def create_oracle_minimizers(distribution):
    """Closed-form Euclidean vs manifold minimizers for a von Mises
    mixture (``plotting_script.py:997-1041``)."""
    modes = np.asarray(distribution.modes, float)
    weights = np.asarray(distribution.weights, float)
    query_input = np.unique(np.cos(modes))[None, :]
    euclidean_height = np.sum(np.sin(modes) * weights, keepdims=True)[:, None]
    acceptable_outputs = np.hstack(
        [np.cos(modes)[:, None], np.sin(modes)[:, None]]
    )
    euclidean_oracle = np.hstack([query_input, euclidean_height])
    angular_oracle = float(np.sum(modes * weights))
    manifold_oracle = _polar2cartesian(1.0, angular_oracle)[None, :]
    return (query_input, acceptable_outputs, weights, euclidean_oracle,
            manifold_oracle)


def plot_oracle_and_pred(distribution, query, accept_outputs,
                         acc_outputs_probs, euclidean_oracle,
                         riemanian_oracle, predictions_dict,
                         inputs_offset=2.0, ax=None, display_legend=True):
    """Panel (B) (``plotting_script.py:470-597``): GT angular density,
    acceptable outputs with their probabilities, MSE vs constrained-MSE
    minimizers, and trained models' predictions at the ambiguous query."""
    t = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
    pdf = distribution.pdf(t)
    ax = plot_angular_density(t, pdf * 0.5, colour=GT_COL, ax=ax,
                              show_center=True, label="GT probability",
                              inputs_offset=inputs_offset)
    ax.scatter(np.asarray(query).ravel()[0], -inputs_offset, label="Inputs",
               c=INP_COL)
    ax.scatter(accept_outputs[:, 0], accept_outputs[:, 1], marker="*",
               label="Constr. MH min.", c=MANI_COL, s=100)
    for p, out in zip(acc_outputs_probs, accept_outputs):
        ax.text(x=out[0] * 1.1, y=out[1] * 1.1, s=f"$p(y|x)={p:.2f}$",
                color=MANI_COL)
    ax.scatter(euclidean_oracle[:, 0], euclidean_oracle[:, 1], marker="o",
               label="MSE minimizer", c=MLP_COL)
    ax.vlines(np.asarray(query).ravel()[0], -inputs_offset,
              float(np.sin(distribution.modes[0])), linestyle="--",
              color="grey", lw=1.5, zorder=0)
    ax.scatter(riemanian_oracle[:, 0], riemanian_oracle[:, 1], marker="o",
               label="Constr. MSE min.", c=CONST_COL)
    for method, preds in predictions_dict.items():
        ax.scatter(preds[:, 0], preds[:, 1], marker="X",
                   label=METHODS_NAMES[method], c=METHODS_COLORS[method])
    if display_legend:
        ax.legend(loc="lower left")
    return ax


def plot_dist_and_samples(distribution, x, y, offset, ax=None,
                          omit_targets=False, display_legend=True):
    """GT density + input/output samples (``plotting_script.py:172-222``)."""
    t = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
    pdf = distribution.pdf(t)
    ax = plot_angular_density(t, pdf * 0.5, colour=GT_COL, ax=ax,
                              show_center=True, label="GT probability",
                              inputs_offset=offset)
    if not omit_targets:
        ax.scatter(y[:, 0], y[:, 1], marker="o", label="Outputs", c=GT_COL)
    ax.scatter(np.asarray(x).ravel(), -offset * np.ones(np.size(x)),
               label="Inputs", c=INP_COL)
    if display_legend:
        ax.legend(loc="upper left")
    return ax


def plot_predictions_panel(distribution, x_test, y_test, predictions_dict,
                           offset=1.5, ax=None, omit_targets=True,
                           display_legend=False):
    """Panels (C)/(D) base (``plotting_script.py:249-287``)."""
    ax = plot_dist_and_samples(distribution, x_test, y_test, offset, ax=ax,
                               omit_targets=omit_targets,
                               display_legend=False)
    for method, preds in predictions_dict.items():
        name = METHODS_NAMES[method]
        if method == "constrained_rmcl":
            name += " - Aggr."
        ax.scatter(preds[:, 0], preds[:, 1], marker="X", label=name,
                   c=METHODS_COLORS[method])
    if display_legend:
        ax.legend(loc="upper left")
    return ax


def plot_hyps(hyps_per_model: Dict[str, Optional[np.ndarray]], ax):
    """ManiPose hypotheses as markers + score rays
    (``plotting_script.py:885-920``): each hypothesis point gets a dashed
    radial segment of length proportional to its score."""
    for model_name, hyp in hyps_per_model.items():
        if hyp is None:
            continue
        hyp = np.asarray(hyp)
        for k in range(hyp.shape[1]):
            hx, hy, score = hyp[:, k, 0], hyp[:, k, 1], hyp[:, k, 2]
            ax.scatter(hx, hy, marker=_HYP_MARKERS[k % len(_HYP_MARKERS)],
                       label=f"{METHODS_NAMES[model_name]} - Hyp. {k}",
                       c=METHODS_COLORS[model_name], alpha=0.6)
            ax.plot([hx, (1 + score) * hx], [hy, (1 + score) * hy],
                    c=METHODS_COLORS[model_name], ls="--", alpha=0.6, lw=2.0,
                    label=(f"{METHODS_NAMES[model_name]} - "
                           + r"scores $\gamma_k$") if k > 0 else None)


# ---------------------------------------------------------------------------
# training harness for the figure (K=2 rMCL, ``plotting_script.py:774-777``)
# ---------------------------------------------------------------------------
def train_figure_models(distribution, seed=0, epochs=50, n_train=1000,
                        n_test=40, n_hyp=2, device="cuda", state_dicts=None):
    """Train mlp / constrained / constrained_rmcl on a circle scenario on
    ``device`` and return (x_test, y_test, preds_per_model, hyps_per_model,
    trainers). Each model starts from flax's default init drawn from
    ``seed`` (``toy.models.init_toy_model``), or from
    ``state_dicts[name]`` where given."""
    from .datasets import LiftingDataset
    from .models import (
        ACTIVATIONS,
        ConstrainedMlp,
        ConstrainedMlpRmcl,
        ToyMlp,
        init_toy_model,
    )
    from .trainer import ToyTrainer, ToyTrainerConfig

    data = LiftingDataset(distribution, n_train, n_train, n_test)
    act = ACTIVATIONS["tanh"]
    specs = {
        "mlp": (ToyMlp(1, 32, 2, 2, act), "plain"),
        "constrained": (ConstrainedMlp(1, 32, 2, act, 1.0), "plain"),
        "constrained_rmcl": (
            ConstrainedMlpRmcl(1, 32, 2, act, 1.0, n_hyp=n_hyp, beta=0.1), "mcl"
        ),
    }
    preds, hyps, trainers = {}, {}, {}
    for name, (model, kind) in specs.items():
        init_toy_model(model, seed)
        if state_dicts is not None:
            model.load_state_dict(state_dicts[name])
        tr = ToyTrainer(
            model,
            ToyTrainerConfig(epochs=epochs, batch_size=100, lr=1e-2,
                             lr_scheduler=True, lr_min=0.0, lr_patience=10,
                             lr_threshold=1e-4, seed=seed),
            model_kind=kind, beta=0.1, device=device,
        )
        tr.train(data.train, val_data=data.val)
        (_, _), (_, p), h = tr.evaluate([data.val, data.test],
                                        lambda pr, y: 0.0)
        preds[name] = np.asarray(p)
        hyps[name] = np.asarray(h[1]) if h is not None else None
        trainers[name] = tr
    return data.x_test, data.y_test, preds, hyps, trainers


def figure4(save_path, seed=0, epochs=50, n_train=1000, n_test=40,
            device="cuda"):
    """Compose the paper's Figure 4 (``plotting_script.py:1109-1237``):
    (A) setting, (B) oracles + point models on hard-2, (C) hard-2
    predictions + hypotheses, (D) hard-4 predictions + hypotheses. The
    models train on ``device``."""
    from .distributions import HardBimodalDist, HardQuadmodalDist

    plt = pyplot()

    hard2 = HardBimodalDist(radius=1.0, random_state=seed)
    hard4 = HardQuadmodalDist(radius=1.0, random_state=seed)

    panels = {}
    for key, dist in (("C", hard2), ("D", hard4)):
        x_te, y_te, preds, hyps, trainers = train_figure_models(
            dist, seed=seed, epochs=epochs, n_train=n_train, n_test=n_test,
            device=device,
        )
        panels[key] = dict(distribution=dist, x=x_te, y=y_te, preds=preds,
                           hyps=hyps, trainers=trainers)

    fig, ax_arr = plt.subplots(2, 2, sharex=True, sharey=True,
                               figsize=(10, 10))
    ax1, ax2, ax3, ax4 = ax_arr.ravel()

    plot_setting(ax=ax1, display_legend=False, offset=1.5)
    ax1.set_title("(A)", weight="bold")

    (query, acc_out, acc_probs, euc, mani) = create_oracle_minimizers(hard2)
    # point-prediction models forwarded at the ambiguous query input
    query_preds = {}
    for name, tr in panels["C"]["trainers"].items():
        if name == "constrained_rmcl":
            continue
        q = np.repeat(query.astype(np.float32), 10, axis=0)
        query_preds[name] = np.asarray(tr.predict(q))[:1]
    plot_oracle_and_pred(hard2, query, acc_out, acc_probs, euc, mani,
                         query_preds, inputs_offset=1.5, ax=ax2,
                         display_legend=False)
    ax2.set_title("(B)", weight="bold")

    for ax, key, title in ((ax3, "C", "(C)"), (ax4, "D", "(D)")):
        d = panels[key]
        preds = {k: v for k, v in d["preds"].items()
                 if not (key == "C" and k == "constrained_rmcl")}
        plot_predictions_panel(d["distribution"], d["x"], d["y"], preds,
                               offset=1.5, ax=ax, omit_targets=True)
        plot_hyps({"constrained_rmcl": d["hyps"]["constrained_rmcl"]}, ax)
        ax.set_title(title, weight="bold")

    handles, labels = [], []
    for ax in (ax1, ax2, ax3, ax4):
        h, l = ax.get_legend_handles_labels()
        handles += h
        labels += l
    by_label = dict(zip(labels, handles))
    fig.legend(by_label.values(), by_label.keys(), loc="lower center",
               ncol=3)
    fig.tight_layout(rect=[0, 0.1, 1, 1])
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return str(save_path)


# ---------------------------------------------------------------------------
def figure8(save_path, seed=123, n_samples=1000, major_radius=2.0,
            minor_radius=1.0):
    """The torus-mixture figure (``tor-plot.py:46-101``): wireframe torus
    + samples colored by mixture component."""
    from .distributions import torus_scenario

    plt = pyplot()
    dist = torus_scenario(major_radius, minor_radius, random_state=seed)
    _, points = dist.sample(n_samples)
    components = np.asarray(dist.picked_components)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlabel("X axis")
    ax.set_ylabel("Y axis")
    ax.set_zlabel("Z axis")
    u = np.linspace(0, 2 * np.pi, 50)
    v = np.linspace(0, 2 * np.pi, 50)
    uu, vv = np.meshgrid(u, v)
    R, r = major_radius, minor_radius
    ax.plot_wireframe((R + r * np.cos(vv)) * np.cos(uu),
                      (R + r * np.cos(vv)) * np.sin(uu),
                      r * np.sin(vv), color="gray", alpha=0.3, zorder=1)
    colors = np.array(["blue", "green", "red", "purple"])
    ax.scatter(points[:, 0], points[:, 1], points[:, 2],
               c=colors[components % len(colors)], zorder=2, s=8)
    ax.view_init(azim=-45, elev=60)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return str(save_path)
