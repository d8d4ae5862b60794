"""PyTorch port vs the JAX package: ``Predictor.predict_video`` with the
same weights (the JAX side running its Pallas attention in interpret
mode), ``from_any``, and import isolation of the port. int8 serving, export
and data-parallel serving are in ``tests/test_torch_port_quant.py``,
``tests/test_torch_port_export.py`` and ``tests/test_torch_port_serve.py``."""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.geometry import h36m_skeleton_17
from manipose_tpu.serving import Predictor as JPredictor
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
# the sizes of tests/test_serving.py
OVERRIDES = [
    "data.seq_len=9",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
TOL = 5e-5  # model-forward tolerance, at unit output scale


@pytest.fixture(scope="module")
def predictors():
    """The JAX Predictor (Pallas attention) and the port's, same weights."""
    j_cfg = j_load_config("config", OVERRIDES + ["model.attn_impl=pallas"])
    xla_model, _ = j_instantiate(j_load_config("config", OVERRIDES),
                                 h36m_skeleton_17())
    params = jax.jit(xla_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 9, 17, 2), jnp.float32)
    )
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )
    j_pred = JPredictor(cfg=j_cfg, variables=params, batch_size=3, tta=True)
    t_pred = Predictor(
        cfg=load_config("config", OVERRIDES), batch_size=3, tta=True,
        state_dict=state_dict_from_jax(params, "rmcl_manifold"), device="cpu",
    )
    return j_pred, t_pred


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("n_frames,stride", [(40, None), (5, None), (20, 3)])
def test_predict_video_matches_jax(predictors, n_frames, stride):
    """Tiling over several padded batches, a video shorter than one window,
    and the overlapping quality mode - each with its hypotheses."""
    j_pred, t_pred = predictors
    video = np.random.default_rng(n_frames).normal(size=(n_frames, 17, 2))
    video = video.astype(np.float32)
    want = j_pred.predict_video(video, return_hypotheses=True,
                                window_stride=stride)
    got = t_pred.predict_video(video, return_hypotheses=True,
                               window_stride=stride)
    assert got[0].shape == (n_frames, 17, 3)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[2].sum(axis=1), 1.0, atol=1e-5)
    _close(t_pred.predict_video(video, window_stride=stride), want[0])


def test_models_without_hypotheses():
    cfg = load_config("config", OVERRIDES + ["model.arch=manifold"])
    pred = Predictor(cfg=cfg, batch_size=2, tta=False, device="cpu")
    video = np.random.default_rng(1).normal(size=(12, 17, 2)).astype(np.float32)
    poses, hyps, scores = pred.predict_video(video, return_hypotheses=True)
    assert poses.shape == (12, 17, 3) and hyps is None and scores is None
    np.testing.assert_array_equal(pred.predict_video(video), poses)


def test_bad_inputs_raise(predictors):
    _, t_pred = predictors
    video = np.zeros((20, 17, 2), np.float32)
    with pytest.raises(ValueError):
        t_pred.predict_video(video, window_stride=9)
    with pytest.raises(ValueError):
        t_pred.predict_video(np.zeros((20, 16, 2), np.float32))
    with pytest.raises(ValueError):
        t_pred.predict_video(np.zeros((0, 17, 2), np.float32))


def test_from_any(tmp_path, predictors):
    _, t_pred = predictors
    cfg = load_config("config", OVERRIDES)
    with pytest.warns(UserWarning, match="random weights"):
        Predictor.from_any("", cfg=cfg, device="cpu")
    path = tmp_path / "model.pth"
    torch.save({"model_pos": t_pred.model.state_dict()}, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = Predictor.from_any(str(path), cfg=cfg, batch_size=3,
                                    device="cpu")
    video = np.random.default_rng(2).normal(size=(9, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict_video(video),
                                  t_pred.predict_video(video))
    # a run directory of the port's training loop: directory/tag/model.pth
    (tmp_path / "run" / "best_mpjpe").mkdir(parents=True)
    path.rename(tmp_path / "run" / "best_mpjpe" / "model.pth")
    from_run = Predictor.from_any(str(tmp_path / "run"), tag="best_mpjpe", cfg=cfg,
                                  device="cpu")
    np.testing.assert_array_equal(from_run.predict_video(video),
                                  t_pred.predict_video(video))
    with pytest.raises(FileNotFoundError):  # no best_val tag in this run
        Predictor.from_any(str(tmp_path / "run"), cfg=cfg, device="cpu")
    (tmp_path / "run" / "best_val").mkdir()  # a tag without model.pth: orbax's
    with pytest.raises(ValueError, match="save_torch_checkpoint"):
        Predictor.from_any(str(tmp_path / "run"), cfg=cfg, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg=load_config("config", OVERRIDES))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the eval slice's data, metrics, eval,
    logging and driver modules, the training slice's loop, checkpoint,
    init, muP and profiling modules, the 3DHP slice's data, driver,
    streaming and tools modules and the serving slice's quant module and
    tools among them, and chip_smoke.py, import
    without loading jax, flax, optax, orbax or manipose_tpu (matched
    exactly: the port shares the prefix)."""
    code = """
import importlib, pkgutil, sys
import manipose_tpu_torch
for m in pkgutil.walk_packages(manipose_tpu_torch.__path__, "manipose_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
walked = {"data.cameras", "data.h36m", "data.h36m_cameras", "data.native",
          "data.pipeline", "data.quaternion", "data.windowing", "drivers.h36m",
          "eval.engine", "metrics.joint_errors", "metrics.pck", "utils.logging",
          "train.checkpoint", "train.init", "train.loop", "train.mup", "train.profiling",
          "data.chunked", "data.dhp3", "data.graph_utils", "drivers.dhp3", "streaming",
          "tools.synthetic_overfit", "tools.make_synthetic_3dhp",
          "tools.make_synthetic_h36m", "tools.streaming_eval", "ops.quant",
          "tools.serve", "tools.predict", "tools.export_model"}
missing = sorted(m for m in walked if "manipose_tpu_torch." + m not in sys.modules)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "orbax", "manipose_tpu")
             or m.startswith(("jax.", "flax.", "optax.", "orbax.", "manipose_tpu.")))
print(missing, bad)
sys.exit(1 if bad or missing else 0)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
