"""The port's offline-analysis tools and the toy Table 1/6 runs against the
JAX package's, on the CPU.

- ``eval_baselines``: seeded (2, 9, 17, 3) dumps through the port's CLI
  (``--device cpu``) and the JAX tool's ``main`` in this process: the same
  printed lines, every number within 1e-5 relative, for both skeletons,
  without targets, with targets, and with ``--pck`` under the three
  alignments.
- ``get_table_data``: byte-equal stdout over toy run dirs and an H36M-style
  dir holding a ``protocol_1_err.csv``.
- ``plot_analysis``: the same set of PNG files as the JAX tool's CLI for
  ``tests/test_analysis_tools.py``'s ``_make_run_dir`` layout; each
  figure's computed data equal to a numpy/pandas recomputation written from
  the JAX source (1e-12 relative: the CSVs are parsed by pandas on one side
  and by ``float`` on the other); the GT joint density's points equal to
  the JAX ``fetch``'s; with ``sys.modules["matplotlib"] = None`` the module
  imports, its data functions run and a drawing raises an ImportError that
  names matplotlib.
- ``quantitative_comparison``: the runs' names and overrides equal the two
  shell scripts', parsed from ``scripts/``; one toy2d seed at 1 epoch (100
  samples) writes the three ``metrics.txt`` that ``get_table_data`` reads.
"""

import contextlib
import importlib
import importlib.util
import io
import pickle
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from manipose_tpu_torch.tools import (
    eval_baselines,
    get_table_data,
    plot_analysis,
    quantitative_comparison,
)

REPO = Path(__file__).resolve().parents[1]
PRINT_TOL = 1e-5
DATA_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: under the suite's workers its intra-op threads
    only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_analysis():
    """``tests/test_analysis_tools.py`` (its ``_make_run_dir``) and through
    it the JAX ``tools/plot_analysis.py``."""
    return _load(REPO / "tests" / "test_analysis_tools.py", "_jax_analysis_tests")


# ---- eval_baselines -----------------------------------------------------------

def _printed(text: str) -> dict:
    """{label: numbers} of the tool's lines (an array may wrap lines)."""
    entries, key = {}, None
    for line in text.splitlines():
        m = re.match(r"^([A-Za-z3][^:\[]*?):\s*(.*)$", line)
        if m:
            key = m.group(1)
            entries[key] = m.group(2)
        elif key is not None:
            entries[key] += " " + line
    num = r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?|nan|inf"
    return {k: [float(v) for v in re.findall(num, rest)] for k, rest in entries.items()}


CASES = {
    "h36m": ([], False),
    "h36m_targets": ([], True),
    "3dhp_pck_none": (["--skeleton=3dhp", "--pck"], True),
    "3dhp_pck_scale": (["--skeleton=3dhp", "--pck", "--alignment=scale"], True),
    "3dhp_pck_procrustes": (["--skeleton=3dhp", "--pck", "--alignment=procrustes"], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_baselines_prints_as_jax(tmp_path, case):
    flags, with_targets = CASES[case]
    rng = np.random.default_rng(0)
    t = rng.normal(scale=100, size=(2, 9, 17, 3)).astype(np.float32)
    p = t + rng.normal(scale=40, size=t.shape).astype(np.float32)
    np.save(tmp_path / "p.npy", p)
    np.savez(tmp_path / "t.npz", targets=t)
    paths = [str(tmp_path / "p.npy")] + ([str(tmp_path / "t.npz")] if with_targets else [])
    jax_tool = _load(REPO / "tools" / "eval_baselines.py", "_jax_tool_eval_baselines")
    outs = {}
    for side, run in (("jax", lambda: jax_tool.main(paths + flags)),
                      ("port", lambda: eval_baselines.main(paths + flags + ["--device", "cpu"]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        outs[side] = buf.getvalue()
    got, want = _printed(outs["port"]), _printed(outs["jax"])
    assert list(got) == list(want), (outs["port"], outs["jax"])
    assert ("3DPCK@150mm (none)" in want) == (case == "3dhp_pck_none")
    assert len(want) == (4 if not with_targets else 7 if "--pck" not in flags else 9) + 1
    for key, values in want.items():
        assert len(got[key]) == len(values), key
        np.testing.assert_allclose(got[key], values, rtol=PRINT_TOL, atol=0, err_msg=key)


# ---- get_table_data -------------------------------------------------------------

def _toy_dir(root: Path, name: str, metrics: dict) -> Path:
    d = root / name / "default"
    d.mkdir(parents=True)
    (d / "metrics.txt").write_text("".join(f"{k}: {v}\n" for k, v in metrics.items())
                                   + "\nmalformed line\nkey: not-a-number\n")
    return d.parent


def test_get_table_data_stdout_equals_jax(tmp_path, jax_analysis, capsys):
    rng = np.random.default_rng(3)
    dirs = [_toy_dir(tmp_path, f"toy2d_{arch}_seed{s}",
                     {"val_mpjpe": rng.uniform(), "test_mpjpe": rng.uniform()})
            for arch in ("mlp", "constrained") for s in (42, 43)]
    for s in (1, 2):
        dirs.append(jax_analysis._make_run_dir(tmp_path, f"h36m_rmcl_seed{s}", s))
    dirs.append(tmp_path / "empty_seed9")
    dirs[-1].mkdir()
    argv = [str(d) for d in dirs]
    groups = get_table_data.main(argv)
    port = capsys.readouterr().out
    saved = sys.argv
    try:
        sys.argv = ["get_table_data.py", *argv]
        runpy.run_path(str(REPO / "tools" / "get_table_data.py"), run_name="__main__")
    finally:
        sys.argv = saved
    assert port == capsys.readouterr().out
    assert sorted(groups) == ["h36m_rmcl", "toy2d_constrained", "toy2d_mlp"]
    assert all(len(ms) == 2 for ms in groups.values())
    assert "seg std" in groups["h36m_rmcl"][0] and "oracle mpjpe" in port


# ---- plot_analysis --------------------------------------------------------------

def _pngs(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*.png")}


def test_plot_analysis_writes_the_jax_files(tmp_path, jax_analysis):
    """The CLI on a run dir with a sweep of one value: the same PNG files
    on each side (the figures over several dirs are held by their data
    below), drawn at a low resolution to save time."""
    import matplotlib

    sides = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        d = jax_analysis._make_run_dir(root, "m1", 0)
        tool = jax_analysis.plot_analysis if side == "jax" else plot_analysis
        with matplotlib.rc_context({"figure.dpi": 20, "savefig.dpi": 20}):
            tool.main([str(d), "--labels", "m1", "--sweep-param", "K=2"])
        sides[side] = _pngs(root)
    assert sides["port"] == sides["jax"] and len(sides["jax"]) == 14


def test_plot_analysis_figure_data_equals_numpy(tmp_path, jax_analysis):
    dirs = [jax_analysis._make_run_dir(tmp_path, f"k{k}", k) for k in (2, 3, 5)]
    labels = ["A", "B", "C"]

    def df(d, name):
        return pd.read_csv(d / f"{name}.csv")

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                                   rtol=DATA_TOL, atol=0)

    # the comparison bars: each suite's "average" row of every dir
    bars = plot_analysis.comparison_rows(dirs, labels)
    assert list(bars) == ["jw_err", "cw_err", "seg_consistency", "seg_symmetry"]
    for name, (items, rows) in bars.items():
        assert list(items) == list(df(dirs[0], name).columns[1:])
        assert [lab for lab, _ in rows] == labels
        for d, (_, values) in zip(dirs, rows):
            close(values, df(d, name).iloc[-1, 1:].astype(float).values)
    # the per-action facets
    actions, items, used, facet = plot_analysis.facet_rows(dirs, labels, "seg_symmetry")
    assert actions == df(dirs[0], "jw_err").iloc[:-1, 0].tolist() == jax_analysis.ACTIONS
    for i, a in enumerate(actions):
        for d, values in zip(dirs, facet[a]):
            close(values, df(d, "seg_symmetry").iloc[i, 1:].astype(float).values)
    # the segment-error histograms' data and names
    errs, names = plot_analysis.seg_err_data(dirs[0])
    np.testing.assert_array_equal(errs, np.load(dirs[0] / "all_seg_errs.npy"))
    assert names == list(df(dirs[0], "seg_consistency").columns[1:])
    # MPJPE vs MPSCE
    points = plot_analysis.consistency_points(dirs, labels)
    want = [(lab, float(df(d, "protocol_1_err")["mpjpe"].iloc[-1]),
             float(df(d, "protocol_1_err")["seg std"].iloc[-1]))
            for d, lab in zip(dirs, labels)]
    assert [p[0] for p in points] == labels
    close([p[1:] for p in points], [w[1:] for w in want])
    # max stretch
    names, values = plot_analysis.max_stretch_bars(dirs[1])
    assert names == list(df(dirs[1], "seg_max_strech").columns[1:])
    close(values, df(dirs[1], "seg_max_strech").iloc[-1, 1:].astype(float).values)
    # the sweep, given out of order
    rows = plot_analysis.sweep_rows(dirs[::-1], [5, 3, 2])
    assert [r["param"] for r in rows] == [2, 3, 5]
    for r, d in zip(rows, dirs):
        close([r["mpjpe"], r["oracle"]],
              [df(d, "protocol_1_err")["mpjpe"].iloc[-1],
               df(d, "protocol_1_err")["oracle mpjpe"].iloc[-1]])
    with pytest.raises(ValueError):
        plot_analysis.sweep_rows(dirs, [1, 2])
    # the multimodality heatmap and the per-frame spread
    data = plot_analysis.multimodality_data(dirs[2])
    with open(dirs[2] / "all_pred_hyps.pkl", "rb") as f:
        per_action = pickle.load(f)
    h0 = per_action[0][0]
    close(data["frame_spread"], np.linalg.norm(
        h0[..., :3] - h0[..., :3].mean(axis=1, keepdims=True), axis=-1).mean(axis=(0, 1, 3)))
    close(data["matrix"], np.stack([np.linalg.norm(
        h[..., :3] - h[..., :3].mean(axis=1, keepdims=True), axis=-1).mean(axis=(0, 1, 2))
        for h, _ in per_action]))
    assert data["matrix"].shape == (3, 17)
    assert data["actions"] == jax_analysis.ACTIONS
    assert data["joints"] == list(df(dirs[2], "jw_err").columns[1:])


def test_gt_joint_density_points_equal_jax(tmp_path):
    """The density's points from the port's ``fetch`` and the JAX one's on
    a synthetic H36M-format npz pair (``tests/test_analysis_tools.py``'s),
    and the port's figure drawn."""
    from manipose_tpu.config import load_config as j_load_config
    from manipose_tpu.data.h36m import fetch as j_fetch
    from manipose_tpu.drivers.h36m import fetch_and_prepare_data as j_prepare
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers.h36m import fetch_and_prepare_data

    data_dir = tmp_path / "h36m"
    data_dir.mkdir()
    rng = np.random.default_rng(0)
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        "S1": {"Walking": rng.normal(scale=0.3, size=(40, 32, 3)).astype(np.float32)}})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        "S1": {"Walking": [rng.uniform(0, 1000, size=(40, 17, 2)).astype(np.float32)
                           for _ in range(4)]}})
    over = [f"data.data_dir={data_dir}", "data.actions=walking"]
    keypoints, dataset = fetch_and_prepare_data(load_config("config", over))
    p2, p3 = plot_analysis.joint_density_points(dataset, keypoints, "S1", "walking", "RWrist")
    j_keypoints, j_dataset = j_prepare(j_load_config("config", over))
    poses_3d, poses_2d, _, _ = j_fetch(["S1"], j_dataset, j_keypoints, action_filter=["walking"])
    j = list(j_dataset.skeleton.joints_names).index("RWrist")
    np.testing.assert_allclose(p3, np.concatenate([np.asarray(p)[:, j] for p in poses_3d]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(p2, np.concatenate([np.asarray(p)[:, j] for p in poses_2d]),
                               rtol=0, atol=1e-6)
    assert p2.shape == (160, 2) and p3.shape == (160, 3)
    out = plot_analysis.plot_gt_joint_density(dataset, keypoints, "S1", "walking", "RWrist",
                                              tmp_path / "dens.png", u_cond=0.1, v_cond=-0.2)
    assert Path(out).stat().st_size > 5_000


def test_plot_analysis_without_matplotlib(tmp_path, jax_analysis, monkeypatch):
    d = jax_analysis._make_run_dir(tmp_path, "run", 0)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    module = importlib.reload(plot_analysis)
    try:
        assert module.max_stretch_bars(d)[1].shape == (16,)
        assert module.multimodality_data(d)["matrix"].shape == (3, 17)
        for draw in (module.plot_max_stretch, module.inspect_multimodality):
            with pytest.raises(ImportError, match="matplotlib"):
                draw(d)
        assert not list(d.glob("*.png"))
    finally:
        monkeypatch.undo()
        importlib.reload(plot_analysis)


# ---- quantitative_comparison ---------------------------------------------------

def _script_runs(setting: str) -> list:
    """(run.experiment, overrides) of each run of
    ``scripts/quantitative_comparison_<setting>.sh``, in its order."""
    text = (REPO / "scripts" / f"quantitative_comparison_{setting}.sh").read_text()
    presets = dict(re.findall(r"\[(\w+)\]=(\w+)", text))
    seeds = re.search(r"for seed in ([\d ]+); do", text).group(1).split()
    archs = re.search(r"for arch in ([\w ]+); do", text).group(1).split()
    command = re.search(r"main_toy\.py(.*?)\"\$@\"", text, re.S).group(1)
    words = command.replace("\\\n", " ").split()
    out = []
    for seed in seeds:
        for arch in archs:
            args = [w.replace("${presets[$arch]}", presets.get(arch, ""))
                    .replace("${arch}", arch).replace("$arch", arch)
                    .replace("${seed}", seed).replace("$seed", seed) for w in words]
            name = next(a.split("=", 1)[1] for a in args if a.startswith("run.experiment="))
            out.append((name, args))
    return out


@pytest.mark.parametrize("setting", ["toy2d", "toy3d"])
def test_quantitative_comparison_runs_equal_the_scripts(setting):
    want = _script_runs(setting)
    got = quantitative_comparison.runs(setting, extra=["x.y=1"])
    assert len(want) == 15
    assert [name for name, _ in got] == [name for name, _ in want]
    assert [args for _, args in got] == [[*args, "x.y=1"] for _, args in want]


def test_quantitative_comparison_toy2d_feeds_get_table_data(tmp_path, capsys):
    out = tmp_path / "outputs_toy"
    results = quantitative_comparison.main([
        "--setting", "toy2d", "--seeds", "42", "train.epochs=1", "data.n_train=100",
        "data.n_val=100", "data.n_test=100", "device=cpu", f"run.output_dir={out}"])
    names = ["toy2d_mlp_seed42", "toy2d_constrained_seed42", "toy2d_constrained_rmcl_seed42"]
    assert [n for n, _ in results] == names
    assert all(np.isfinite(v) for _, v in results)
    capsys.readouterr()
    groups = get_table_data.main([str(out / n) for n in names])
    table = capsys.readouterr().out
    assert sorted(groups) == ["toy2d_constrained", "toy2d_constrained_rmcl", "toy2d_mlp"]
    for ms in groups.values():
        (m,) = ms
        assert set(m) == {"val_mpjpe", "test_mpjpe", "val_dtc", "test_dtc"}
        assert np.isfinite(list(m.values())).all()
    assert "| toy2d_mlp | 1 |" in table
