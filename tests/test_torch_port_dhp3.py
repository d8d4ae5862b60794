"""The port's MPI-INF-3DHP path against the JAX package's, on the CPU.

Graph adjacencies, the chunked batchers, ``Dataset3DHP``, the FK-synthetic
generators and the 3DHP driver. The driver runs of both packages share one
module fixture: FK-synthetic 3DHP archives from the port's generator (one
train sequence on two cameras of 60 frames, TS1-TS6 of 30 frames, about
5 % invalid; TS5/TS6 at 1920x1080), one init written as a ``.pth``, and
``drivers.dhp3.main`` of both packages from it: the small
config of ``tests/test_driver_3dhp.py`` (2 layers of 32 channels, 4 heads,
a segments trunk 16 wide, K = 2, L = 9, batch 4), drop-path off, 3 epochs
with validation and MPJPE every epoch, then the PCK/AUC protocol. Both
sides draw the same batches (the loaders' numpy streams are the same).
The init is the port's seeded one, written as a reference ``.pth``
(``{"model_pos": state dict}``), which both drivers load.

Tolerances:
- ``metrics.csv`` losses and MPJPE, and ``test_metrics.csv``: 1e-4
  relative (fp32 over a dozen Adam steps whose sums run in another order
  on each side), ``tests/test_torch_port_loop.py``'s; PCK and AUC within
  one joint-frame's share, 100 / (valid frames * 17), since a threshold may
  flip on rounding;
- the four analytics CSVs: 1e-4 of each column's largest value;
- the generators: ``data_3d`` within 1e-3 mm and 2D within 1e-2 px (float32
  FK in two frameworks), keys, shapes and ``valid`` masks equal;
- graph adjacencies, batches and dataset arrays: equal.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.data import chunked as j_chunked
from manipose_tpu.data import dhp3 as j_dhp3
from manipose_tpu.data.graph_utils import adj_mx_from_skeleton as j_adj_mx_from_skeleton
from manipose_tpu.drivers.dhp3 import main as j_main
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.data import chunked, dhp3
from manipose_tpu_torch.data.graph_utils import adj_mx_from_skeleton
from manipose_tpu_torch.drivers import dhp3 as driver
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.tools import make_synthetic_3dhp, make_synthetic_h36m

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 3
METRIC_TOL = 1e-4
ANALYTICS_TOL = 1e-4
EVAL_ONLY_TOL = 1e-6
GEN_3D_TOL_MM = 1e-3
GEN_2D_TOL_PX = 1e-2
OVERRIDES = [
    "data=mpi_inf_3dhp", "data.seq_len=9", "train=debug", f"train.epochs={EPOCHS}",
    "train.batch_size=4", "train.batch_size_test=4",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
]
TIMING_COLUMNS = {"train_seconds", "valid_seconds", "mpjpe_seconds",
                  "checkpoint_seconds", "epoch_seconds"}
ANALYTICS = ("seg_symmetry", "seg_consistency", "jw_err", "cw_err")
GRAPH_TYPES = ("default", "double_chain", "terminal_cycle", "centralized", "paired")
REFINE_TYPES = ("default", "self_weakening", "self_reinforcement")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models on one thread: torch's intra-op threads only contend
    with the test suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- graphs
@pytest.mark.parametrize("graph_type", GRAPH_TYPES)
@pytest.mark.parametrize("refine_type", REFINE_TYPES)
def test_adjacency_matches_jax(graph_type, refine_type):
    got = adj_mx_from_skeleton(h36m_skeleton_17(), graph_type, refine_type)
    want = j_adj_mx_from_skeleton(j_skeleton(), graph_type, refine_type)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_invalid_graph_types_raise():
    with pytest.raises(ValueError, match="graph kernel"):
        adj_mx_from_skeleton(h36m_skeleton_17(), "ring")
    with pytest.raises(ValueError, match="refinement"):
        adj_mx_from_skeleton(h36m_skeleton_17(), "default", "sharpen")


# ---------------------------------------------------------------- batchers
def _videos(seed):
    rng = np.random.default_rng(seed)
    keys = ["TS1", "TS2", "TS5"]
    lengths = [23, 9, 14]
    poses_3d = {k: rng.normal(size=(n, 17, 3)).astype(np.float32)
                for k, n in zip(keys, lengths)}
    poses_2d = {k: rng.normal(size=(n, 17, 2)).astype(np.float32)
                for k, n in zip(keys, lengths)}
    cams = {k: rng.normal(size=(9,)).astype(np.float32) for k in keys}
    valid = {k: rng.uniform(size=n) > 0.3 for k, n in zip(keys, lengths)}
    return cams, poses_3d, poses_2d, valid


def _batches(gen):
    return [(cams, p3, p2, keys) for cams, p3, p2, keys in gen]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gc, g3, g2, gk), (wc, w3, w2, wk) in zip(got, want):
        assert gk == wk
        np.testing.assert_array_equal(g3, w3)
        np.testing.assert_array_equal(g2, w2)
        assert len(gc) == len(wc)
        for a, b in zip(gc, wc):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augment,reverse_aug,out_all", [
    (True, True, True), (True, False, False), (False, True, True), (False, False, False)])
def test_chunked_generator_train_mode_matches_jax(augment, reverse_aug, out_all):
    """Shuffled, padded clips with flip and reverse augmentation, the
    intrinsics' x terms mirrored with the flip: two epochs of one
    generator, so the second shuffle is held too."""
    cams, p3, p2, _ = _videos(0)
    sk = h36m_skeleton_17()
    kw = dict(batch_size=5, cameras=cams, poses_3d=p3, poses_2d=p2, chunk_length=4,
              pad=3, causal_shift=1, shuffle=True, random_seed=7, augment=augment,
              reverse_aug=reverse_aug, kps_left=sk.joints_left, kps_right=sk.joints_right,
              joints_left=sk.joints_left, joints_right=sk.joints_right, out_all=out_all)
    got, want = chunked.ChunkedGenerator(**kw), j_chunked.ChunkedGenerator(**kw)
    assert got.pairs == want.pairs and len(got) == len(want)
    assert got.num_frames() == want.num_frames()
    for _ in range(2):
        _assert_same_batches(_batches(got), _batches(want))


def test_chunked_generator_test_mode_matches_jax():
    """One single-frame chunk per valid frame, edge padding, no cameras."""
    _, p3, p2, valid = _videos(1)
    kw = dict(batch_size=6, cameras=None, poses_3d=p3, poses_2d=p2, pad=4,
              train=False, valid_frame=valid)
    got, want = chunked.ChunkedGenerator(**kw), j_chunked.ChunkedGenerator(**kw)
    assert got.pairs == want.pairs
    assert len(got.pairs) == sum(int(v.sum()) for v in valid.values())
    _assert_same_batches(_batches(got), _batches(want))
    with pytest.raises(ValueError, match="valid_frame"):
        chunked.ChunkedGenerator(6, None, p3, p2, train=False)


def test_pose_generator_matches_jax():
    rng = np.random.default_rng(2)
    p3 = [rng.normal(size=(n, 17, 3)) for n in (4, 6)]
    p2 = [rng.normal(size=(n, 17, 2)) for n in (4, 6)]
    actions = [["walking"] * 4, ["eating"] * 6]
    cams = [rng.normal(size=(n, 9)) for n in (4, 6)]
    got, want = chunked.PoseGenerator(p3, p2, actions, cams), \
        j_chunked.PoseGenerator(p3, p2, actions, cams)
    assert len(got) == len(want) == 10
    for i in range(10):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        chunked.PoseGenerator(p3, p2, actions[:1], cams)


# ---------------------------------------------------------------- dataset
@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The port's FK-synthetic 3DHP archives, the driver tests' data."""
    return make_synthetic_3dhp.generate(tmp_path_factory.mktemp("dhp3"), train_seqs=1,
                                        cams=2, frames=60, test_frames=30, seed=0)


@pytest.mark.parametrize("train", [True, False])
def test_dataset_matches_jax(archives, train):
    got, want = dhp3.Dataset3DHP(archives, train), j_dhp3.Dataset3DHP(archives, train)
    assert len(got.poses) == len(want.poses) == (2 if train else 6)
    for a, b in zip(got.poses + got.poses_2d, want.poses + want.poses_2d):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if not train:  # invalid frames dropped
        assert sum(len(p) for p in got.poses) < 6 * 30
    s, js = got.skeleton, want.skeleton
    for field in ("parents", "joints_left", "joints_right", "joints_names",
                  "t_pose_operators", "bones", "bones_names"):
        assert getattr(s, field) == getattr(js, field), field
    assert dhp3.MAP_H36M_TO_MPI_JOINTS == j_dhp3.MAP_H36M_TO_MPI_JOINTS


# ---------------------------------------------------------------- generators
def _walk(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            yield from _walk(got[k], want[k], f"{path}/{k}")
    else:
        yield path, np.asarray(got), np.asarray(want)


def _load(path, key):
    return np.load(path, allow_pickle=True)[key].item()


def test_make_synthetic_3dhp_matches_jax_tool(tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    import make_synthetic_3dhp as j_tool

    kw = dict(train_seqs=1, cams=2, frames=40, test_frames=40, seed=3)
    j_tool.generate(tmp_path / "jax", **kw)
    make_synthetic_3dhp.generate(tmp_path / "port", **kw)
    for name in ("data_train_3dhp.npz", "data_test_3dhp.npz"):
        for path, got, want in _walk(_load(tmp_path / "port" / name, "data"),
                                     _load(tmp_path / "jax" / name, "data")):
            assert got.shape == want.shape and got.dtype == want.dtype, path
            if path.endswith("valid"):
                np.testing.assert_array_equal(got, want, err_msg=path)
            else:
                tol = GEN_3D_TOL_MM if path.endswith("data_3d") else GEN_2D_TOL_PX
                np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=path)


def test_make_synthetic_h36m_matches_jax_tool(tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    import make_synthetic_h36m as j_tool

    j_tool.generate(tmp_path / "jax", ["S1", "S9"], 2, 40, seed=1)
    make_synthetic_h36m.generate(tmp_path / "port", ["S1", "S9"], 2, 40, seed=1)
    for name, key, tol in (("data_3d_h36m.npz", "positions_3d", GEN_3D_TOL_MM / 1000.0),
                           ("data_2d_h36m_cpn_ft_h36m_dbb.npz", "positions_2d",
                            GEN_2D_TOL_PX)):
        for path, got, want in _walk(_load(tmp_path / "port" / name, key),
                                     _load(tmp_path / "jax" / name, key)):
            assert got.shape == want.shape and got.dtype == want.dtype, path
            np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=path)


def test_generators_refuse_poses_outside_the_frame(tmp_path, monkeypatch):
    monkeypatch.setattr(make_synthetic_3dhp, "INTRINSICS", {
        wh: (100 * f, cx, cy) for wh, (f, cx, cy) in make_synthetic_3dhp.INTRINSICS.items()})
    with pytest.raises(RuntimeError, match="outside the sensors"):
        make_synthetic_3dhp.generate(tmp_path, train_seqs=1, cams=1, frames=10,
                                     test_frames=10)


# ---------------------------------------------------------------- driver
@pytest.fixture(scope="module")
def runs(archives, tmp_path_factory):
    """{"jax": run dir, "port": run dir, "eval_only": the port's eval-only
    run dir from its best_mpjpe tag, "best": best MPJPE of each}."""
    root = tmp_path_factory.mktemp("dhp3_runs")
    model, _ = instantiate_model(load_config("config", OVERRIDES), dhp3.dhp3_skeleton())
    pth = root / "init.pth"  # a reference .pth: {"model_pos": state dict}
    torch.save({"model_pos": model.state_dict()}, pth)
    common = OVERRIDES + [f"data.data_dir={archives}", f"run.checkpoint_model={pth}"]
    best = {
        "jax": j_main(j_load_config("config", common + [f"run.output_dir={root / 'jax'}"])),
        "port": driver.main(load_config("config", common + [
            f"run.output_dir={root / 'port'}", "device=cpu"])),
    }
    port = root / "port" / "default"
    eval_only = driver.main(load_config("config", OVERRIDES + [
        f"data.data_dir={archives}", f"run.output_dir={root / 'port'}", "device=cpu",
        "run.train=false", "run.experiment=evalonly",
        f"run.checkpoint_params={port / 'best_mpjpe'}"]))
    return {"jax": root / "jax" / "default", "port": port,
            "eval_only": root / "port" / "evalonly", "best": best,
            "eval_only_result": eval_only}


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _valid_frames(archives) -> int:
    cfg = load_config("config", OVERRIDES)
    loader = driver.create_loader(dhp3.Dataset3DHP(archives, train=False), cfg, train=False)
    return len(loader.dataset) * cfg.data.seq_len


def test_driver_metrics_csv_matches_jax(runs):
    got, want = _rows(runs["port"] / "metrics.csv"), _rows(runs["jax"] / "metrics.csv")
    assert len(got) == len(want) == EPOCHS
    assert set(got[0]) - set(want[0]) == TIMING_COLUMNS
    for g, w in zip(got, want):
        for col, value in w.items():
            if col == "seq_per_sec":
                continue
            if value == "" or col in ("step", "lr") or col.startswith("best_epoch"):
                assert g[col] == value, (col, g[col], value)
            else:
                assert abs(float(g[col]) - float(value)) <= METRIC_TOL * abs(float(value)), (
                    col, g[col], value)
    assert abs(runs["best"]["port"] - runs["best"]["jax"]) <= METRIC_TOL * runs["best"]["jax"]


def test_driver_test_metrics_match_jax(runs, archives):
    (got,), (want,) = _rows(runs["port"] / "test_metrics.csv"), \
        _rows(runs["jax"] / "test_metrics.csv")
    assert list(got) == list(want)
    assert {"pck", "auc", "agg_pck", "agg_auc", "best_val_mpjpe", "sag_sym",
            "seg_std", "best_val_oracle_mpjpe", "best_val_ps_oracle_mpjpe"} == set(want)
    joint_frame = 100.0 / (_valid_frames(archives) * 17)
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        if k in ("pck", "auc", "agg_pck", "agg_auc"):
            assert 0.0 <= g <= 100.0 and abs(g - w) <= joint_frame, (k, g, w, joint_frame)
        else:
            assert abs(g - w) <= METRIC_TOL * abs(w), (k, g, w)


@pytest.mark.parametrize("name", ANALYTICS)
def test_driver_analytics_match_jax(runs, name):
    def table(d):
        with open(d / f"{name}.csv", newline="") as f:
            head, *rows = list(csv.reader(f))
        return head, np.asarray(rows, float)

    (g_head, g), (w_head, w) = table(runs["port"]), table(runs["jax"])
    assert g_head == w_head and g.shape == w.shape == (1, len(w_head))
    scale = np.abs(w).max(axis=0, keepdims=True)
    assert (np.abs(g - w) <= ANALYTICS_TOL * scale).all(), (g, w)


def test_driver_writes_the_jax_tags(runs):
    def tags(d):
        return sorted(p.name for p in d.iterdir() if p.is_dir())

    assert tags(runs["port"]) == tags(runs["jax"])
    assert "best_mpjpe" in tags(runs["port"])


def test_eval_only_from_the_best_tag_reproduces_the_run(runs):
    assert runs["eval_only_result"] is None  # nothing trained
    (trained,), (again,) = _rows(runs["port"] / "test_metrics.csv"), \
        _rows(runs["eval_only"] / "test_metrics.csv")
    for key, value in trained.items():
        assert np.isclose(float(again[key]), float(value), rtol=EVAL_ONLY_TOL, atol=0), key
    for name in ANALYTICS:
        assert (runs["eval_only"] / f"{name}.csv").is_file()


def test_protocol_returns_the_predictions_it_scored(runs, archives, tmp_path):
    """``run_test_protocol(return_predictions=True)`` returns the trained
    run's metrics and the aggregated poses of its own ``evaluate``."""
    from manipose_tpu_torch.eval.engine import EvalConfig, evaluate
    from manipose_tpu_torch.weights import load_torch_checkpoint

    cfg = load_config("config", OVERRIDES + ["device=cpu"])
    dataset = dhp3.Dataset3DHP(archives, train=False)
    model, rmcl = instantiate_model(cfg, dataset.skeleton)
    model.load_state_dict(load_torch_checkpoint(runs["port"] / "best_mpjpe" / "model.pth"))
    model.eval()
    metrics, preds = driver.run_test_protocol(model, cfg, dataset, rmcl, tmp_path,
                                              return_predictions=True)
    (trained,) = _rows(runs["port"] / "test_metrics.csv")
    assert list(metrics) == list(trained)
    for key, value in trained.items():
        assert np.isclose(metrics[key], float(value), rtol=EVAL_ONLY_TOL, atol=0), key
    loader = driver.create_loader(dataset, cfg, train=False)
    agg = evaluate(model, loader, dataset.skeleton,
                   EvalConfig(tta=cfg.train.tta, rmcl=rmcl, compute_oracle=rmcl))[0]
    assert preds.shape == (len(loader.dataset), cfg.data.seq_len, 17, 3)
    np.testing.assert_array_equal(preds, np.concatenate(agg, axis=0))


def test_driver_refuses_what_it_does_not_run(archives, tmp_path):
    """parallel.pipe=2 without a process group of two raises the ValueError
    that names the torchrun launch; the megastep (train.steps_per_call=2)
    runs."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        driver.main(load_config("config", OVERRIDES + [
            f"data.data_dir={archives}", "device=cpu", "parallel.pipe=2"]))
    best = driver.main(load_config("config", OVERRIDES + [
        f"data.data_dir={archives}", "device=cpu", "train.steps_per_call=2",
        "train.epochs=1", f"run.output_dir={tmp_path}"]))
    assert np.isfinite(best)
    assert np.isfinite(np.load(tmp_path / "default" / "train_loss.npy")).all()
    with pytest.raises(ValueError, match="mpi_inf_3dhp"):
        driver.main(load_config("config", ["device=cpu"]))


def test_module_entry_point_inserts_the_data_group_and_wants_a_card():
    """``python -m manipose_tpu_torch.drivers.dhp3`` with no data override
    reads the 3DHP group, and without ``device=cpu`` asks for the card: here,
    with no CUDA device, it raises before touching the data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.run([sys.executable, "-m", "manipose_tpu_torch.drivers.dhp3",
                           "data.data_dir=/nonexistent"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-2000:]
    assert driver.overrides_with_data_group(["a=1"]) == ["data=mpi_inf_3dhp", "a=1"]
    for given in (["data.dataset=3dhp"], ["data=mpi_inf_3dhp", "data.seq_len=9"]):
        assert driver.overrides_with_data_group(given) == given
