"""The port's training driver against the JAX package's, on the CPU.

One module fixture writes seeded H36M-format npz files (S1, S9 and S11,
two actions, four cameras, 60 frames), draws the JAX model's init, writes
it as a ``.pth`` with ``manipose_tpu.train.checkpoint.save_torch_checkpoint``
and runs ``drivers.h36m.main`` of both packages from it with
``run.train=true`` (S1 trains, S11 validates and tests): the small config
of ``tests/test_driver_h36m.py`` (2 layers of 32 channels, 4 heads, a
segments trunk 16 wide, K = 2, L = 9, batch 4), drop-path off, 3 epochs
with validation and MPJPE every epoch, and ``train.lr_patience=0`` with
``train.lr_threshold=0.5`` so that the plateau scheduler halves the
learning rate inside the run (the validation loss falls by 15-20 % an
epoch, under the 50 % it asks for). Both
sides draw the same batches (the loaders' numpy streams are the same).

Tolerances:
- per-epoch train and validation losses, and every loss and MPJPE column
  of ``metrics.csv``: 1e-4 relative (fp32 over a few dozen Adam steps
  whose sums run in another order on each side); the learning rate and
  the best-epoch columns equal; the port's extra columns are host-clock
  timings only, as ``seq_per_sec``, which is not compared;
- the ``best_mpjpe`` weights: within 2 * n_steps * lr * (1 - b1) /
  sqrt(1 - b2), twice the most Adam can move a parameter over the run;
- the test protocol's table after training: 1e-4 of each column's
  largest value (``tests/test_torch_port_eval.py``'s protocol tolerance).
"""

import csv

import numpy as np
import pytest
import torch

import orbax.checkpoint as ocp

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import init_model_params as j_init_model_params
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.drivers.h36m import main as j_main
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.train.checkpoint import save_torch_checkpoint
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers.h36m import main
from manipose_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

EPOCHS = 3
LR = 4e-5
BETA1, BETA2 = 0.9, 0.999
LOSS_TOL = 1e-4
PROTOCOL_TOL = 1e-4
OVERRIDES = [
    "data.seq_len=9", "data.data=one", "data.actions=walking,eating", "train=debug",
    f"train.epochs={EPOCHS}", "train.lr_patience=0", "train.lr_threshold=0.5",
    f"train.lr={LR}",
    "train.batch_size=4", "train.batch_size_test=4",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
]
# the port's extra metrics.csv columns: host-clock timings and, on the card,
# peak memory (train/loop.py)
TIMING_COLUMNS = {"train_seconds", "valid_seconds", "mpjpe_seconds",
                  "checkpoint_seconds", "epoch_seconds"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models on one thread: torch's intra-op threads only contend
    with the test suite's other workers for the cores (the module ran ten
    times slower under them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_h36m(data_dir):
    """``tests/test_driver_h36m.py``'s seeded npz pair."""
    rng = np.random.default_rng(0)
    subjects, actions, n_frames = ["S1", "S9", "S11"], ["Walking", "Eating"], 60
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        s: {a: rng.normal(scale=0.3, size=(n_frames, 32, 3)).astype(np.float32)
            for a in actions} for s in subjects})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        s: {a: [rng.uniform(0, 1000, size=(n_frames, 17, 2)).astype(np.float32)
                for _ in range(4)] for a in actions} for s in subjects})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": run dir, "port": run dir, "best": best MPJPE of each}."""
    root = tmp_path_factory.mktemp("train_runs")
    data_dir = root / "h36m"
    data_dir.mkdir()
    write_h36m(data_dir)
    j_cfg = j_load_config("config", OVERRIDES)
    model, _ = j_instantiate(j_cfg, j_skeleton())
    pth = root / "init.pth"
    save_torch_checkpoint(pth, j_init_model_params(model, j_cfg, 17), "rmcl_manifold")
    common = OVERRIDES + [f"data.data_dir={data_dir}", f"run.checkpoint_model={pth}"]
    best = {
        "jax": j_main(j_load_config("config", common + [f"run.output_dir={root / 'jax'}"])),
        "port": main(load_config("config", common + [f"run.output_dir={root / 'port'}",
                                                     "device=cpu"])),
    }
    return {"jax": root / "jax" / "default", "port": root / "port" / "default",
            "best": best}


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows


def test_losses_match_jax(runs):
    for name in ("train_loss.npy", "valid_loss.npy"):
        got, want = np.load(runs["port"] / name), np.load(runs["jax"] / name)
        assert got.shape == want.shape == (EPOCHS,), name
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0, err_msg=name)
    assert abs(runs["best"]["port"] - runs["best"]["jax"]) <= LOSS_TOL * runs["best"]["jax"]


def test_metrics_csv_matches_jax(runs):
    """Every column of the JAX run's metrics.csv but seq_per_sec, epoch by
    epoch; the plateau scheduler halved the learning rate in the run."""
    got, want = _read_csv(runs["port"] / "metrics.csv"), _read_csv(runs["jax"] / "metrics.csv")
    assert len(got) == len(want) == EPOCHS
    assert set(got[0]) - set(want[0]) == TIMING_COLUMNS
    lrs = [float(r["lr"]) for r in want]
    assert lrs[0] == LR and lrs[-1] < LR, lrs
    for g, w in zip(got, want):
        for col, value in w.items():
            if col == "seq_per_sec":
                continue
            if value == "" or col in ("step", "lr") or col.startswith("best_epoch"):
                assert g[col] == value, (col, g[col], value)
            else:
                assert abs(float(g[col]) - float(value)) <= LOSS_TOL * abs(float(value)), (
                    col, g[col], value)


def test_same_tags_as_jax(runs):
    def tags(d):
        return sorted(p.name for p in d.iterdir() if p.is_dir())

    assert tags(runs["port"]) == tags(runs["jax"])
    assert "best_mpjpe" in tags(runs["port"]) and "end" in tags(runs["port"])


def test_best_mpjpe_weights_within_the_adam_envelope(runs):
    """The port's best_mpjpe/model.pth against the JAX run's orbax tag,
    mapped through ``state_dict_from_jax``."""
    with ocp.StandardCheckpointer() as ckptr:
        j_vars = ckptr.restore((runs["jax"] / "best_mpjpe").resolve())
    want = state_dict_from_jax(j_vars, "rmcl_manifold")
    got = load_torch_checkpoint(runs["port"] / "best_mpjpe" / "model.pth")
    assert set(got) == set(want)
    steps = EPOCHS * -(-_train_windows(runs) // 4)  # batches of 4, the last padded
    envelope = 2 * steps * LR * (1 - BETA1) / np.sqrt(1 - BETA2)
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst <= envelope, (worst, envelope)


def _train_windows(runs) -> int:
    """Windows of the train split (S1, two actions, four cameras)."""
    from manipose_tpu_torch.drivers import create_loader, get_subjects_and_actions
    from manipose_tpu_torch.drivers.h36m import fetch_and_prepare_data

    cfg = load_config("config", OVERRIDES + [
        f"data.data_dir={runs['port'].parent.parent / 'h36m'}"])
    keypoints, dataset = fetch_and_prepare_data(cfg)
    (subjects, _, _), actions = get_subjects_and_actions(dataset, cfg)
    return len(create_loader(keypoints, dataset, actions, subjects, cfg).dataset)


def test_protocol_after_training_matches_jax(runs):
    def table(d):
        with open(d / "protocol_1_err.csv", newline="") as f:
            head, *rows = list(csv.reader(f))
        return head, [r[0] for r in rows], np.asarray([r[1:] for r in rows], float)

    t_head, t_acts, t_vals = table(runs["port"])
    j_head, j_acts, j_vals = table(runs["jax"])
    assert t_head == j_head and t_acts == j_acts == ["walking", "eating", "average"]
    scale = np.abs(j_vals).max(axis=0, keepdims=True)
    assert (np.abs(t_vals - j_vals) <= PROTOCOL_TOL * scale).all()
