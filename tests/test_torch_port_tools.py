"""The port's seeding, TPE, MLflow fallback and run-the-model tools
against the JAX package's, on the CPU: ``utils/seeding`` (streams bit for
bit), ``utils/tpe`` (spaces, proposals and journals over 12 trials, resume),
``MetricLogger(mlflow_on=True)``, ``count_n_params`` (equal counts),
``robustness_sweep`` (the table from the same ``.pth``), ``step_ablation``'s
ablated forwards from the same weights, one smoke each of ``bench_eval``,
``bench_sustained`` and ``synthetic_overfit`` at the smallest size that
runs (their numbers are the card's), and ``hp_search`` on the toy driver
with a journal that resumes.

Models are small (d <= 32, depth <= 2, L = 9), except ``bench_sustained``,
whose model is the flagship's, on 4 windows of 9 frames. Tolerances:
numpy-only code equal; the sweep's table 1e-4 relative (evaluations of the
same weights, rounded to 1e-3 mm on both sides); forwards 5e-5 of
max(1, |ref|max), the JAX package's model tolerance.
"""

import dataclasses
import importlib.util
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import init_model_params, instantiate_model as j_instantiate
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.utils import logging as j_logging
from manipose_tpu.utils import seeding as j_seeding
from manipose_tpu.utils import tpe as j_tpe
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.tools import (
    bench_eval,
    bench_sustained,
    count_n_params,
    hp_search,
    robustness_sweep,
    step_ablation,
    synthetic_overfit,
)
from manipose_tpu_torch.utils import logging as t_logging
from manipose_tpu_torch.utils import seeding as t_seeding
from manipose_tpu_torch.utils import tpe as t_tpe
from manipose_tpu_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
L, J = 9, 17
SMALL = [
    f"data.seq_len={L}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
]
MODEL_TOL = 5e-5
SWEEP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: under the suite's workers its intra-op threads
    only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _json_lines(out: str):
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


# ---- utils/seeding ---------------------------------------------------------

@pytest.mark.parametrize("seed,epoch", [(0, 0), (42, 3), (7, 199)])
def test_epoch_rng_streams_equal_jax(seed, epoch):
    got = t_seeding.epoch_rng(seed, epoch)
    want = j_seeding.epoch_rng(seed, epoch)
    np.testing.assert_array_equal(got.integers(0, 2**62, size=64),
                                  want.integers(0, 2**62, size=64))
    np.testing.assert_array_equal(got.permutation(100), want.permutation(100))


def test_set_random_seeds_seeds_as_jax():
    """python's and numpy's global state as the JAX helper leaves them, the
    same numpy stream, and a torch generator seeded with the seed."""
    draws = []
    for mod in (j_seeding, t_seeding):
        _, rng = mod.set_random_seeds(42)
        draws.append((random.random(), np.random.random(4).tolist(), rng.normal(size=4)))
    (jr, jn, jg), (tr, tn, tg) = draws
    assert jr == tr and jn == tn
    np.testing.assert_array_equal(jg, tg)
    gen, _ = t_seeding.set_random_seeds(42)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 42


# ---- utils/tpe -------------------------------------------------------------

SPACE = ["x=uniform:-1,2", "lr=loguniform:1e-4,1e-1", "d=int:1,6", "h=choice:16,32,64"]


def _objective(params, trial):
    """A fixed numpy objective; trial 4 fails (None), as a crashed run."""
    if trial == 4:
        return None
    return ((params["x"] - 0.4) ** 2 + (np.log10(params["lr"]) + 2.5) ** 2
            + 0.1 * abs(params["d"] - 3) + {"16": 0.3, "32": 0.0, "64": 0.2}[params["h"]])


def test_parse_space_equals_jax():
    for got, want in zip(t_tpe.parse_space(SPACE), j_tpe.parse_space(SPACE)):
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_sweep_proposals_and_journal_equal_jax(tmp_path, sampler, capsys):
    """12 trials (5 uniform start-up trials, then TPE): the same proposals,
    the same best trial and byte-identical journals; a resumed sweep adds
    no trial and proposes nothing."""
    results = {}
    for side, mod in (("jax", j_tpe), ("port", t_tpe)):
        space = mod.parse_space(SPACE)
        cls = mod.TPESampler if sampler == "tpe" else mod.RandomSampler
        journal = tmp_path / f"{side}.jsonl"
        results[side] = mod.run_sweep(_objective, space, 12, sampler=cls(space, seed=3),
                                      journal=journal, verbose=False)
    (jb, jv, jh), (tb, tv, th) = results["jax"], results["port"]
    assert th == jh and (tb, tv) == (jb, jv) and len(th) == 12
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()

    space = t_tpe.parse_space(SPACE)
    calls = []
    again = t_tpe.run_sweep(lambda p, t: calls.append(t), space, 12,
                            sampler=t_tpe.TPESampler(space, seed=3),
                            journal=tmp_path / "port.jsonl")
    assert not calls and again[2] == th and again[:2] == (tb, tv)
    assert "resumed 12 trials" in capsys.readouterr().out
    assert len((tmp_path / "port.jsonl").read_text().splitlines()) == 12


def test_hp_search_on_the_toy_driver_resumes(tmp_path, capsys):
    """``hp_search --driver toy`` on the CPU: 3 trials of a cut toy run with
    a finite best objective, then a second call on the journal runs none."""
    journal = tmp_path / "sweep.jsonl"
    argv = ["--driver", "toy", "--trials", "3", "--journal", str(journal),
            "--space", "train.lr=loguniform:1e-3,1e-2", "--",
            "data.scenario=hard-2", "data.n_train=100", "data.n_val=100",
            "data.n_test=100", "train.epochs=2", "device=cpu",
            f"run.output_dir={tmp_path}"]
    best_params, best_value, history = hp_search.main(argv)
    assert len(history) == 3 and np.isfinite(best_value)
    assert 1e-3 <= best_params["train.lr"] <= 1e-2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hp_trial_0", "hp_trial_1", "hp_trial_2", "sweep.jsonl"]
    capsys.readouterr()
    again = hp_search.main(argv)
    assert again[2] == history and "resumed 3 trials" in capsys.readouterr().out
    assert len(journal.read_text().splitlines()) == 3


# ---- utils/logging: the MLflow fallback ------------------------------------

def test_metric_logger_falls_back_without_mlflow(tmp_path):
    """Without mlflow both loggers read ``mlflow_on`` False, keep the
    history, take ``log_params`` as a no-op and write the same CSV."""
    for side, mod in (("jax", j_logging), ("port", t_logging)):
        logger = mod.MetricLogger(mlflow_on=True, experiment="exp",
                                  tracking_uri=str(tmp_path / "mlruns"))
        assert logger.mlflow_on is False
        logger.log_params({"train.lr": 4e-5, "model.arch": "rmcl_manifold"})
        logger.log({"tr_loss": 0.5, "val_mpjpe": 41.25}, step=0)
        logger.log({"tr_loss": 0.25}, step=1)
        assert logger.history == [{"step": 0, "tr_loss": 0.5, "val_mpjpe": 41.25},
                                  {"step": 1, "tr_loss": 0.25}]
        (tmp_path / side).mkdir()
        logger.save_csv(tmp_path / side)
    assert not (tmp_path / "mlruns").exists()
    assert ((tmp_path / "port" / "metrics.csv").read_bytes()
            == (tmp_path / "jax" / "metrics.csv").read_bytes())


# ---- count_n_params ----------------------------------------------------------

def test_count_n_params_equals_jax(capsys):
    """The three archs' counts at a narrow override equal the JAX tool's
    count of every flax variable (its ``init_model_params``, traced for the
    shapes only), and are printed as it prints them."""
    over = ["model.channels=64", "model.layers=2", "model.channels_seg=32",
            "model.layers_seg=2", "data.seq_len=27"]
    got = count_n_params.main(over)
    want = {}
    for arch in count_n_params.ARCHS:
        cfg = j_load_config("config", [f"model.arch={arch}", *over])
        model, _ = j_instantiate(cfg, j_skeleton())
        variables = jax.eval_shape(lambda: init_model_params(model, cfg, 17))
        want[arch] = sum(p.size for p in jax.tree_util.tree_leaves(variables))
    assert got == want
    out = capsys.readouterr().out.splitlines()
    assert out == [f"{arch}: {n:,} params" for arch, n in want.items()]


# ---- robustness_sweep --------------------------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_params(arch="rmcl_manifold"):
    model, _ = j_instantiate(j_load_config("config", SMALL + [f"model.arch={arch}"]),
                             j_skeleton())
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, L, J, 2)))
    rng = np.random.default_rng(0)
    return model, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def test_robustness_sweep_matches_jax(tmp_path):
    """The sweep on an S1/S9/S11 archive (40 frames of walking, 4 cameras)
    from one reference-format ``.pth``: the same grid (clean, random at
    0.2, noisy at sigma 5) and every MPJPE, oracle and pseudo-oracle MPJPE
    within 1e-4 relative of the JAX tool's, and the same CSV header."""
    rng = np.random.default_rng(0)
    data_dir = tmp_path / "h36m"
    data_dir.mkdir()
    subjects = ("S1", "S9", "S11")
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        s: {"Walking": rng.normal(scale=0.3, size=(40, 32, 3)).astype(np.float32)}
        for s in subjects})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        s: {"Walking": [rng.uniform(0, 1000, size=(40, 17, 2)).astype(np.float32)
                        for _ in range(4)]} for s in subjects})
    _, params = _small_params()
    torch.save({"model_pos": state_dict_from_jax(params, "rmcl_manifold")},
               tmp_path / "ckpt.pth")
    rows = {}
    for side, mod in (("jax", _jax_tool("robustness_sweep")), ("port", robustness_sweep)):
        rows[side] = mod.main([
            "--checkpoint", str(tmp_path / "ckpt.pth"), "--miss-types", "random", "noisy",
            "--miss-rates", "0.2", "--noise-sigmas", "5", "--out", str(tmp_path / f"{side}.csv"),
            f"data.data_dir={data_dir}", "data.actions=walking", "train.batch_size_test=4",
            *SMALL, *(["device=cpu"] if side == "port" else [])])
    got, want = rows["port"], rows["jax"]
    assert [(r["miss_type"], r["miss_rate"], r["noise_sigma"]) for r in got] == [
        (r["miss_type"], r["miss_rate"], r["noise_sigma"]) for r in want] == [
        ("no_miss", 0.0, 0.0), ("random", 0.2, 0.0), ("noisy", 0.0, 5.0)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("mpjpe_mm", "oracle_mpjpe_mm", "ps_oracle_mpjpe_mm"):
            assert abs(g[k] - w[k]) <= SWEEP_TOL * abs(w[k]), (g, w, k)
    assert ((tmp_path / "port.csv").read_text().splitlines()[0]
            == (tmp_path / "jax.csv").read_text().splitlines()[0])


# ---- step_ablation: the ablated models ------------------------------------------

def _jax_ablations():
    """The JAX tool's RMCLNoSeg and RMCLNoDecode (local classes of its
    ``main``), as it defines them."""
    from flax import linen as nn

    from manipose_tpu.models.decoder import decode_poses
    from manipose_tpu.models.manifold import BonesMixSTE
    from manipose_tpu.models.rmcl import RMCLRotMixSTE

    class RMCLNoSeg(nn.Module):
        cfg: object
        skeleton: object

        def setup(self):
            self.rotations_module = RMCLRotMixSTE(self.cfg, name="rotations_module")
            self.segments_module = BonesMixSTE(self.cfg, name="segments_module")

        def __call__(self, x, deterministic: bool = True):
            rotations, scores = self.rotations_module(x, deterministic)
            lengths = jnp.ones((x.shape[0], 1, 1, self.cfg.num_bones), rotations.dtype)
            roots = jnp.zeros(rotations.shape[:-2] + (3,), rotations.dtype)
            return decode_poses(rotations, lengths, roots, self.skeleton,
                                self.cfg.rot_rep_dim), scores

    class RMCLNoDecode(nn.Module):
        cfg: object
        skeleton: object

        def setup(self):
            self.rotations_module = RMCLRotMixSTE(self.cfg, name="rotations_module")

        def __call__(self, x, deterministic: bool = True):
            rots, scores = self.rotations_module(x, deterministic)
            return rots[..., :3], scores

    return {"no_seg": RMCLNoSeg, "no_decode": RMCLNoDecode}


@pytest.mark.parametrize("name", ["no_seg", "no_decode"])
def test_ablated_forwards_match_jax(name):
    """RMCLNoSeg (the full model's weights) and RMCLNoDecode (their
    ``rotations_module`` part) in eval mode, within 5e-5 of the magnitude
    of the JAX tool's classes, poses and scores."""
    from manipose_tpu.models import ManifoldConfig as JManifoldConfig
    from manipose_tpu_torch.models import ManifoldConfig

    widths = dict(num_frame=L, embed_dim_rot=32, depth_rot=2, num_heads_rot=4,
                  embed_dim_seg=16, depth_seg=2, num_heads_seg=4, n_hyp=2,
                  drop_path_rate=0.0)
    j_model = _jax_ablations()[name](JManifoldConfig(**widths), j_skeleton())
    model = step_ablation.build(name, ManifoldConfig(**widths), h36m_skeleton_17())
    _, params = _small_params()
    sd = state_dict_from_jax(params, "rmcl_manifold")
    if name == "no_decode":
        params = {"params": {"rotations_module": params["params"]["rotations_module"]}}
        sd = {k: v for k, v in sd.items() if k.startswith("rotations_module.")}
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(5).normal(size=(3, L, J, 2)).astype(np.float32)
    want = jax.jit(j_model.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= MODEL_TOL * max(1.0, float(np.abs(w).max()))


# ---- CPU smokes of the timing tools ---------------------------------------------

def test_bench_eval_prints_its_json(capsys):
    """One line of JSON, the JAX tool's keys, a positive frames/s (16
    windows of L = 9 frames at the small widths)."""
    record = bench_eval.main([*SMALL, "device=cpu"])
    assert _json_lines(capsys.readouterr().out) == [record]
    assert sorted(record) == ["metric", "tta", "unit", "value"]
    assert record["metric"] == "rmcl_manipose_243f_eval_throughput"
    assert record["unit"] == "frames/s" and record["tta"] is True and record["value"] > 0


def test_bench_sustained_prints_its_json(capsys):
    """The flagship bf16 model through the loader, prefetch and the train
    step on 2 videos of 20 frames (4 windows of 9, batch 2: 2 timed full
    batches)."""
    record = bench_sustained.main(["--epochs", "1", "--batch", "2", "--videos", "2",
                                   "--frames", "20", "--seq-len", str(L), "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == [record]
    assert record["metric"] == "rmcl_manipose_sustained_train_throughput"
    assert record["n_sequences"] == 4 and record["seq_len"] == L
    assert record["steps_per_call"] == 1 and record["nheads_seg"] == 8
    assert record["unit"] == "seq/s" and record["value"] > 0


def test_synthetic_overfit_reports(capsys):
    """One epoch of the small model at L = 9: the report's MPJPEs finite,
    the baseline that of the FK videos, and the JAX tool's lines printed."""
    report = synthetic_overfit.train_and_evaluate(epochs=1, seq_len=L, small=True,
                                                  device="cpu")
    assert all(np.isfinite(v) and v > 0 for v in report.values())
    assert 200.0 < report["zero_baseline_mm"] < 1000.0
    out = capsys.readouterr().out
    for line in ("predict-zero baseline:", "untrained: mpjpe", "epoch 1: loss", "FINAL: mpjpe"):
        assert line in out
