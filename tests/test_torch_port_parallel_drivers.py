"""The port's drivers under ``torchrun --nproc-per-node 2 ... device=cpu``
(two gloo CPU ranks): H36M with ``parallel.data=2``, 3DHP with
``parallel.pipe=2`` and with ``model.attn_impl=ring parallel.model=2``.

Each run trains two epochs of a small rMCL model and runs the test
protocol. Its result is finite, rank 0 alone wrote the run directory, and
every checkpoint holds the single-device layout: key for key, shape for
shape, the tags of a one-process run of the same settings, and
``Predictor.from_any`` serves its best tag. The pipe and ring runs split
no batch, so their best validation MPJPE is the one-process run's, within
1e-4 relative (reduction order); a data-parallel run keeps the padded last
batch whole (as the JAX mesh loop does) and is held to finiteness.
"""

import re

import numpy as np
import pytest
import torch

from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import dhp3, h36m
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.tools import make_synthetic_3dhp
from manipose_tpu_torch.weights import load_torch_checkpoint
from torch_ranks import torchrun

MODEL = ["model.layers=2", "model.channels=32", "model.nheads=4", "model.layers_seg=2",
         "model.channels_seg=16", "model.nheads_seg=4", "multi_hyp.n_hyp=2",
         "model.drop_path_rate=0.0", "train=debug", "train.epochs=2",
         "train.batch_size=4", "train.batch_size_test=4", "data.seq_len=9", "device=cpu"]
H36M = MODEL + ["data.data=one", "data.actions=walking,eating"]
DHP3 = ["data=mpi_inf_3dhp"] + MODEL
TAGS = ("best_val", "best_mpjpe", "end")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    """Seeded H36M-format npz files: S1, S9, S11, two actions, four
    cameras, 60 frames."""
    data_dir = tmp_path_factory.mktemp("h36m_parallel")
    rng = np.random.default_rng(0)
    subjects, actions, n_frames = ["S1", "S9", "S11"], ["Walking", "Eating"], 60
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        s: {a: rng.normal(scale=0.3, size=(n_frames, 32, 3)).astype(np.float32)
            for a in actions} for s in subjects})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        s: {a: [rng.uniform(0, 1000, size=(n_frames, 17, 2)).astype(np.float32)
                for _ in range(4)] for a in actions} for s in subjects})
    return data_dir


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    return make_synthetic_3dhp.generate(tmp_path_factory.mktemp("dhp3_parallel"),
                                        train_seqs=1, cams=2, frames=60, test_frames=30,
                                        seed=0)


@pytest.fixture(scope="module")
def dhp3_world1(archives, tmp_path_factory):
    out = tmp_path_factory.mktemp("dhp3_world1")
    cfg = load_config("config", DHP3 + [f"data.data_dir={archives}",
                                        f"run.output_dir={out}"])
    return dhp3.main(cfg), out / "default", cfg


def _best(output: str) -> float:
    values = re.findall(r"best_valid_mpjpe: ([0-9.eE+-]+|nan|inf)", output)
    assert values, output[-3000:]
    return float(values[-1])


def _layout(path):
    return {k: (tuple(v.shape), v.dtype) for k, v in load_torch_checkpoint(path).items()}


def _check_run(run, world1_run, cfg):
    """Rank 0 wrote the run; its tags hold the one-process layout, finite,
    and the best tag serves."""
    assert not list(run.parent.glob("manipose-rank-*"))
    for tag in TAGS:
        weights = load_torch_checkpoint(run / tag / "model.pth")
        assert _layout(run / tag / "model.pth") == _layout(world1_run / tag / "model.pth")
        assert all(torch.isfinite(v).all() for v in weights.values()), tag
    state = sorted(run.glob("train_state_*[0-9]"))[-1] / "train_state.pth"
    want = sorted(world1_run.glob("train_state_*[0-9]"))[-1] / "train_state.pth"
    got, ref = (torch.load(p, weights_only=True) for p in (state, want))
    assert len(got["generators"]) == 2 and "generators" not in ref
    for i, st in ref["optimizer"]["state"].items():
        assert {k: tuple(v.shape) for k, v in got["optimizer"]["state"][i].items()} == \
            {k: tuple(v.shape) for k, v in st.items()}
    served = Predictor.from_any(str(run), tag="best_mpjpe", cfg=cfg, device="cpu")
    best = load_torch_checkpoint(run / "best_mpjpe" / "model.pth")
    assert all(torch.equal(served.model.state_dict()[k], v) for k, v in best.items())


def test_h36m_driver_with_data_parallel(h36m_dir, tmp_path):
    args = H36M + [f"data.data_dir={h36m_dir}"]
    out = torchrun(2, "manipose_tpu_torch.drivers.h36m",
                   args + ["parallel.data=2", f"run.output_dir={tmp_path / 'dp'}"])
    assert np.isfinite(_best(out))
    assert "Training on mesh {'data': 2, 'model': 1}, mode=tp" in out
    cfg = load_config("config", args + [f"run.output_dir={tmp_path / 'one'}"])
    assert np.isfinite(h36m.main(cfg))
    run = tmp_path / "dp" / "default"
    _check_run(run, tmp_path / "one" / "default", cfg)
    rows = (run / "protocol_1_err.csv").read_text().splitlines()
    assert rows[-1].startswith("average")


@pytest.mark.parametrize("extra", [["parallel.pipe=2"],
                                   ["model.attn_impl=ring", "parallel.model=2"]],
                         ids=["pipe", "ring"])
def test_dhp3_driver_under_torchrun_matches_one_process(archives, dhp3_world1, tmp_path,
                                                         extra):
    best1, world1_run, cfg = dhp3_world1
    out = torchrun(2, "manipose_tpu_torch.drivers.dhp3",
                   DHP3 + [f"data.data_dir={archives}", f"run.output_dir={tmp_path}",
                           *extra])
    best = _best(out)
    assert np.isfinite(best)
    np.testing.assert_allclose(best, best1, rtol=1e-4)
    assert "mode=dp" in out  # tp becomes dp under a pipe or a ring
    _check_run(tmp_path / "default", world1_run, cfg)
    assert (tmp_path / "default" / "test_metrics.csv").exists()
