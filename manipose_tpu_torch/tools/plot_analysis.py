"""Offline analysis plots over driver artifacts, reproducing the outputs
of the reference notebook suite (hpe/useful_aux_scripts/):

  plot_histograms.py        -> model-comparison bar suites (per-joint /
                               per-coordinate / per-bone / per-bone-pair)
                               + per-action facet grids + per-bone
                               segment-error histograms
  plot_je_vs_consistency.py -> MPJPE vs MPSCE scatter across experiments
  plot_max_stretching.py    -> per-bone max-stretch bars
  plot_nhyps_lineplot.py    -> aggregated+oracle MPJPE vs K (and vs beta)
                               over a run sweep
  inspect_multimodality.py  -> per-action/per-joint hypothesis-spread
                               heatmap (model side) and GT joint-density
                               projections (data side, needs the dataset)

The port's copy of ``tools/plot_analysis.py``. Every plot works from the
artifacts the port's H36M driver writes per run dir: protocol_1_err.csv,
jw_err.csv, cw_err.csv, seg_consistency.csv, seg_symmetry.csv,
seg_max_strech.csv, all_seg_errs.npy, all_pred_hyps.pkl. Each figure has a
function that computes what it draws (``comparison_rows``, ``facet_rows``,
``seg_err_data``, ``consistency_points``, ``max_stretch_bars``,
``sweep_rows``, ``multimodality_data``, ``joint_density_points``), which
needs neither matplotlib nor pandas; the CSVs are read with the standard
library. Drawing needs matplotlib, imported only when a figure is drawn;
without it a drawing function raises an ImportError that names it.

  python -m manipose_tpu_torch.tools.plot_analysis RUN_DIR [RUN_DIR2 ...] \\
      [--labels A B] [--sweep-param K=2,3,5]
"""

from __future__ import annotations

import argparse
import csv
import pickle
from pathlib import Path

import numpy as np

COMPARISON_SUITES = (
    ("jw_err", "Joint-wise MPJPE [mm]", "jw_err_bars.png"),
    ("cw_err", "Coordinate-wise MPJPE [mm]", "cw_err_bars.png"),
    ("seg_consistency", "Per-bone seg. length STD [mm]", "seg_consistency_bars.png"),
    ("seg_symmetry", "Per-bone symmetry gap [mm]", "seg_symmetry_bars.png"),
)


class Table:
    """A driver CSV (``utils.logging.save_csv_log``): a header and rows of
    strings, the first column the action."""

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]

    def __len__(self) -> int:
        return len(self.rows)

    def values(self, i: int) -> np.ndarray:
        """Row ``i``'s columns after the first, as floats (``-1``: the
        "average" row)."""
        return np.asarray(self.rows[i][1:], float)

    def column(self, name: str) -> np.ndarray:
        k = self.columns.index(name)
        return np.asarray([r[k] for r in self.rows], float)

    def labels(self) -> list:
        """The first column of every row but the last ("average")."""
        return [r[0] for r in self.rows[:-1]]


def load_table(out_dir: Path, name: str):
    path = Path(out_dir) / f"{name}.csv"
    if not path.exists():
        return None
    with open(path, newline="") as f:
        columns, *rows = list(csv.reader(f))
    return Table(columns, rows)


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or an ImportError that
    names matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            f"drawing the analysis plots needs matplotlib, which does not import ({e}); "
            "the figures' data functions of tools.plot_analysis run without it"
        ) from e
    return plt


def _bar_groups(ax, items, rows, labels, colors=None):
    """Grouped bars: ``rows`` are 1D arrays over the common ``items``."""
    n_models = len(rows)
    width = 0.8 / n_models
    xs = np.arange(len(items))
    for m, (values, label) in enumerate(zip(rows, labels)):
        ax.bar(xs + (m - (n_models - 1) / 2) * width, values, width=width, label=label,
               color=None if colors is None else colors[m % len(colors)])
    ax.set_xticks(xs)
    ax.set_xticklabels(items, rotation=80, fontsize=7)


# ---------------------------------------------------------------------------
# plot_histograms.py equivalents
# ---------------------------------------------------------------------------
def comparison_rows(out_dirs, labels) -> dict:
    """{suite: (items, [(label, the "average" row)])} over the dirs that
    hold the suite's CSV (reference plot_histograms.py:88-331)."""
    out = {}
    for name, _, _ in COMPARISON_SUITES:
        rows, items = [], None
        for d, lab in zip(out_dirs, labels):
            table = load_table(d, name)
            if table is None:
                continue
            items = items or table.columns[1:]
            rows.append((lab, table.values(-1)))
        if rows:
            out[name] = (items, rows)
    return out


def plot_model_comparison_bars(out_dirs, labels, save_dir: Path):
    """Joint-wise / coordinate-wise / per-bone consistency / per-bone-pair
    symmetry grouped bars across models, from the driver CSVs."""
    data = comparison_rows(out_dirs, labels)
    written = []
    for name, ylabel, fname in COMPARISON_SUITES:
        if name not in data:
            continue
        plt = pyplot()
        items, rows = data[name]
        fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(items)), 3.5))
        _bar_groups(ax, items, [v for _, v in rows], [lab for lab, _ in rows])
        ax.set_ylabel(ylabel)
        ax.legend(ncol=len(rows), fontsize=8)
        fig.savefig(Path(save_dir) / fname, bbox_inches="tight")
        plt.close(fig)
        written.append(Path(save_dir) / fname)
    return written


def facet_rows(out_dirs, labels, metric: str = "jw_err"):
    """(actions, items, labels, {action: [each model's row]}) of ``metric``
    over the dirs that hold it, the first dir's actions; None if none
    does."""
    tables = [(lab, t) for d, lab in zip(out_dirs, labels)
              if (t := load_table(d, metric)) is not None]
    if not tables:
        return None
    actions = tables[0][1].labels()
    rows = {a: [t.values(i) for _, t in tables] for i, a in enumerate(actions)}
    return actions, tables[0][1].columns[1:], [lab for lab, _ in tables], rows


def plot_per_action_facets(out_dirs, labels, save_dir: Path, metric: str = "jw_err"):
    """Per-action facet grid of a per-joint/bone metric across models (the
    per-action depth of reference plot_histograms.py)."""
    data = facet_rows(out_dirs, labels, metric)
    if data is None:
        return None
    plt = pyplot()
    actions, items, used, rows = data
    n = len(actions)
    ncols = 3
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 2.6 * nrows),
                             sharex=True, squeeze=False)
    for i, action in enumerate(actions):
        ax = axes[i // ncols][i % ncols]
        _bar_groups(ax, items, rows[action], used)
        ax.set_title(str(action), fontsize=9)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].set_axis_off()
    axes[0][0].legend(fontsize=8)
    fig.suptitle(f"{metric} per action")
    out = Path(save_dir) / f"{metric}_per_action.png"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def seg_err_data(out_dir: Path):
    """(segment errors (N, num_bones), bone names or None), None without
    ``all_seg_errs.npy``; the names come from the consistency CSV when its
    columns match."""
    path = Path(out_dir) / "all_seg_errs.npy"
    if not path.exists():
        return None
    errs = np.load(path)
    table = load_table(out_dir, "seg_consistency")
    names = None
    if table is not None and len(table.columns) == errs.shape[1] + 1:
        names = table.columns[1:]
    return errs, names


def plot_seg_err_histograms(out_dir: Path):
    """Segment-error distributions: pooled + per-bone facet grid
    (plot_histograms.py per-bone depth)."""
    data = seg_err_data(out_dir)
    if data is None:
        return
    plt = pyplot()
    errs, names = data
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.hist(errs.ravel(), bins=80)
    ax.set_xlabel("segment length error (mm)")
    ax.set_ylabel("count")
    fig.savefig(Path(out_dir) / "seg_err_hist.png", bbox_inches="tight")
    plt.close(fig)

    nb = errs.shape[1]
    ncols = 4
    nrows = int(np.ceil(nb / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2 * nrows), squeeze=False)
    for b in range(nb):
        ax = axes[b // ncols][b % ncols]
        ax.hist(errs[:, b], bins=40)
        ax.set_title(names[b] if names else f"bone {b}", fontsize=8)
    for j in range(nb, nrows * ncols):
        axes[j // ncols][j % ncols].set_axis_off()
    fig.suptitle("segment length error per bone (mm)")
    fig.tight_layout()
    fig.savefig(Path(out_dir) / "seg_err_hist_per_bone.png", bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
def consistency_points(out_dirs, labels=None) -> list:
    """[(label, MPJPE, MPSCE)] of the dirs with a protocol table, from its
    "average" row (plot_je_vs_consistency.py)."""
    labels = labels or [Path(d).name for d in out_dirs]
    points = []
    for d, lab in zip(out_dirs, labels):
        table = load_table(d, "protocol_1_err")
        if table is None:
            continue
        points.append((lab, float(table.column("mpjpe")[-1]),
                       float(table.column("seg std")[-1])))
    return points


def plot_je_vs_consistency(out_dirs, labels=None):
    """Joint error vs MPSCE scatter across experiments."""
    points = consistency_points(out_dirs, labels)
    if not points:
        return
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    for name, mpjpe, mpsce in points:
        ax.scatter(mpjpe, mpsce)
        ax.annotate(name, (mpjpe, mpsce), fontsize=8)
    ax.set_xlabel("MPJPE (mm)")
    ax.set_ylabel("MPSCE (mm)")
    fig.savefig(Path(out_dirs[0]) / "je_vs_consistency.png", bbox_inches="tight")
    plt.close(fig)


def max_stretch_bars(out_dir: Path):
    """(bone names, the "average" row of seg_max_strech.csv), or None."""
    table = load_table(out_dir, "seg_max_strech")
    if table is None:
        return None
    return table.columns[1:], table.values(-1)


def plot_max_stretch(out_dir: Path):
    """Per-bone max stretch bars (plot_max_stretching.py)."""
    data = max_stretch_bars(out_dir)
    if data is None:
        return
    plt = pyplot()
    names, vals = data
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(len(vals)), vals)
    ax.set_xticks(range(len(vals)))
    ax.set_xticklabels(names, rotation=80, fontsize=7)
    ax.set_ylabel("max stretch (mm)")
    fig.savefig(Path(out_dir) / "max_stretch.png", bbox_inches="tight")
    plt.close(fig)


# ---------------------------------------------------------------------------
# plot_nhyps_lineplot.py equivalent: sweep lineplots from run dirs
# ---------------------------------------------------------------------------
def sweep_rows(out_dirs, sweep_values) -> list:
    """[{"param", "mpjpe"[, "oracle"]}] of each dir's protocol table,
    sorted by the swept value."""
    if len(out_dirs) != len(sweep_values):
        raise ValueError(f"{len(out_dirs)} run dirs vs {len(sweep_values)} sweep values")
    rows = []
    for d, v in zip(out_dirs, sweep_values):
        table = load_table(d, "protocol_1_err")
        if table is None:
            continue
        row = {"param": v, "mpjpe": float(table.column("mpjpe")[-1])}
        if "oracle mpjpe" in table.columns:
            row["oracle"] = float(table.column("oracle mpjpe")[-1])
        rows.append(row)
    rows.sort(key=lambda r: r["param"])
    return rows


def plot_sweep_lineplot(out_dirs, sweep_values, save_dir: Path, param_name: str = "K"):
    """Aggregated + oracle MPJPE vs a swept hyper-parameter
    (plot_nhyps_lineplot.py:47-61, from run artifacts)."""
    rows = sweep_rows(out_dirs, sweep_values)
    if not rows:
        return None
    plt = pyplot()
    xs = [r["param"] for r in rows]
    fig, ax = plt.subplots(figsize=(4, 2.5))
    ax.plot(xs, [r["mpjpe"] for r in rows], "--", marker="o", lw=2,
            label="Aggregated MPJPE")
    if all("oracle" in r for r in rows):
        ax.plot(xs, [r["oracle"] for r in rows], marker="s", lw=2, label="Oracle MPJPE")
    ax.set_xticks(xs)
    ax.set_xlabel(f"{param_name}")
    ax.set_ylabel("[mm]")
    ax.legend(loc=0, fontsize=8)
    ax.grid(True, alpha=0.4)
    out = Path(save_dir) / f"sweep_{param_name}_lineplot.png"
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


# ---------------------------------------------------------------------------
# inspect_multimodality.py equivalents
# ---------------------------------------------------------------------------
def hypothesis_spread(hyps: np.ndarray) -> np.ndarray:
    """(N, H, L, J, 4+) hypotheses -> (N, H, L, J) distances (mm) of each
    hypothesis from their mean."""
    xyz = np.asarray(hyps)[..., :3]
    return np.linalg.norm(xyz - xyz.mean(axis=1, keepdims=True), axis=-1)


def multimodality_data(out_dir: Path):
    """From ``all_pred_hyps.pkl`` (a list over actions of (hypotheses (N,
    H, L, J, 4), targets)): {"frame_spread": the first action's spread per
    frame (L,), "matrix": the spread per action and joint (A, J),
    "actions": the protocol table's actions when there is one per entry,
    "joints": jw_err.csv's joints}; None without the pickle."""
    path = Path(out_dir) / "all_pred_hyps.pkl"
    if not path.exists():
        return None
    with open(path, "rb") as f:
        per_action = pickle.load(f)
    actions = None
    table = load_table(out_dir, "protocol_1_err")
    if table is not None and len(table) - 1 == len(per_action):
        actions = table.labels()
    jw = load_table(out_dir, "jw_err")
    return {
        "frame_spread": hypothesis_spread(per_action[0][0]).mean(axis=(0, 1, 3)),
        "matrix": np.stack([hypothesis_spread(h).mean(axis=(0, 1, 2))
                            for h, _ in per_action]),
        "actions": actions,
        "joints": None if jw is None else jw.columns[1:],
    }


def inspect_multimodality(out_dir: Path):
    """Model-side multimodality: per-action x per-joint hypothesis-spread
    heatmap + per-frame spread line."""
    data = multimodality_data(out_dir)
    if data is None:
        return
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(data["frame_spread"])
    ax.set_xlabel("frame")
    ax.set_ylabel("hypothesis spread (mm)")
    fig.savefig(Path(out_dir) / "hypothesis_spread.png", bbox_inches="tight")
    plt.close(fig)

    mat = data["matrix"]
    fig, ax = plt.subplots(figsize=(max(6, 0.4 * mat.shape[1]), max(3, 0.35 * mat.shape[0])))
    im = ax.imshow(mat, aspect="auto", cmap="viridis")
    ax.set_xticks(range(mat.shape[1]))
    ax.set_xticklabels(data["joints"] or range(mat.shape[1]), rotation=80, fontsize=7)
    ax.set_yticks(range(mat.shape[0]))
    ax.set_yticklabels(data["actions"] or range(mat.shape[0]), fontsize=7)
    fig.colorbar(im, label="hypothesis spread (mm)")
    ax.set_title("multi-hypothesis spread per action / joint")
    fig.savefig(Path(out_dir) / "multimodality_heatmap.png", bbox_inches="tight")
    plt.close(fig)


def joint_density_points(dataset, keypoints, subject: str, action: str, joint: str):
    """(2D positions (N, 2), 3D positions (N, 3)) of ``joint`` over every
    camera of ``subject``'s ``action`` (inspect_multimodality.py:118-200),
    through the port's ``data.h36m.fetch``."""
    from ..data.h36m import fetch

    poses_3d, poses_2d, _, _ = fetch([subject], dataset, keypoints, action_filter=[action])
    j = list(dataset.skeleton.joints_names).index(joint)
    p3 = np.concatenate([np.asarray(p)[:, j] for p in poses_3d], axis=0)
    p2 = np.concatenate([np.asarray(p)[:, j] for p in poses_2d], axis=0)
    return p2, p3


def plot_gt_joint_density(dataset, keypoints, subject: str, action: str, joint: str,
                          save_path, u_cond=None, v_cond=None):
    """Data-side multimodality: GT joint-position density projected on the
    (u, z) and (v, z) planes over all cameras, with optional conditioning
    lines. Needs the H36M dataset."""
    p2, p3 = joint_density_points(dataset, keypoints, subject, action, joint)
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(7, 3.2), sharex=True, sharey=True)
    for ax, horiz, cond in ((ax1, p2[:, 0], u_cond), (ax2, p2[:, 1], v_cond)):
        ax.hist2d(horiz, p3[:, 2], bins=60, cmap="Blues")
        if cond is not None:
            ax.axvline(cond, color="r", linestyle="--")
        ax.set_ylabel("z")
    ax1.set_xlabel("u")
    ax2.set_xlabel("v")
    fig.suptitle(f"{joint} density — {subject}/{action} (all cameras)")
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="+", type=Path)
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--sweep-param", default=None,
                   help="NAME=v1,v2,... maps run dirs to a swept HP")
    args = p.parse_args(argv)

    dirs = args.dirs
    labels = args.labels or [d.name for d in dirs]
    for d in dirs:
        plot_seg_err_histograms(d)
        plot_max_stretch(d)
        inspect_multimodality(d)
    plot_je_vs_consistency(dirs, labels)
    plot_model_comparison_bars(dirs, labels, dirs[0])
    for metric in ("jw_err", "seg_consistency", "seg_symmetry"):
        plot_per_action_facets(dirs, labels, dirs[0], metric)
    if args.sweep_param:
        name, _, vals = args.sweep_param.partition("=")
        values = [float(v) for v in vals.split(",")]
        plot_sweep_lineplot(dirs, values, dirs[0], name)
    print("wrote plots to", ", ".join(str(d) for d in dirs))


if __name__ == "__main__":
    main()
