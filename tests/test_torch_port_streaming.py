"""The port's streaming sessions against the JAX package's, on the CPU.

One module fixture draws the JAX model's init at the sizes of
``tests/test_streaming.py`` (2 layers of 32 channels, 4 heads, K = 2,
L = 9), perturbs it from a numpy seed so that no weight sits at an init
constant, and builds the JAX ``Predictor`` and the port's from the same
weights (``state_dict_from_jax``), batch 1 and TTA on. The JAX side runs
its XLA attention: the Pallas kernels are held against the port's plain
versions in ``tests/test_torch_port_ops.py``; here the session's windowing,
emission and flush are under test.

Tolerances: a session against the JAX session within 5e-5 of the output's
magnitude (the JAX package's model-forward tolerance); against the port's
own ``predict_video`` within 1e-6 (the same one-window forward); chunked
pushes equal single-frame pushes exactly; ``streaming_eval`` rows within
1e-3 mm of the JAX tool's (both round to 1e-3 mm).
"""

import sys
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
from manipose_tpu.train.checkpoint import save_torch_checkpoint
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.streaming import StreamingSession
from manipose_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
SEQ_LEN = 9
OVERRIDES = [
    f"data.seq_len={SEQ_LEN}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
TOL = 5e-5  # model-forward tolerance, of the output's magnitude
OFFLINE_TOL = 1e-6
STREAM_EVAL_TOL_MM = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models on one thread: torch's intra-op threads only contend
    with the test suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    model, _ = j_instantiate(j_load_config("config", OVERRIDES), h36m_skeleton_17())
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ_LEN, 17, 2), jnp.float32)
    )
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def predictors(params):
    """The JAX Predictor and the port's, same weights, batch 1, TTA on."""
    j_pred = JPredictor(cfg=j_load_config("config", OVERRIDES), variables=params,
                        batch_size=1, tta=True)
    t_pred = Predictor(cfg=load_config("config", OVERRIDES), batch_size=1, tta=True,
                       state_dict=state_dict_from_jax(params, "rmcl_manifold"),
                       device="cpu")
    return j_pred, t_pred


def stream_all(predictor, video, stride, lookahead, chunk=1):
    sess = predictor.stream(stride=stride, lookahead=lookahead)
    outs = [sess.push(video[i : i + chunk]) for i in range(0, len(video), chunk)]
    outs.append(sess.flush())
    return np.concatenate(outs, axis=0)


def _video(seed, n=20):
    return np.random.default_rng(seed).normal(size=(n, 17, 2)).astype(np.float32)


@pytest.mark.parametrize("stride,lookahead", [(1, 0), (3, 4), (1, None), (SEQ_LEN, 0)])
def test_session_matches_jax(predictors, stride, lookahead):
    j_pred, t_pred = predictors
    video = _video(stride)
    want = stream_all(j_pred, video, stride, lookahead)
    got = stream_all(t_pred, video, stride, lookahead)
    assert got.shape == want.shape == (len(video), 17, 3)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("n_frames", [4, SEQ_LEN, 2 * SEQ_LEN, 25])
def test_offline_equivalence(predictors, n_frames):
    """stride = seq_len, lookahead = 0 reproduces predict_video: the same
    non-overlapping windows and replicate tail padding, one window a
    forward on both paths (batch 1)."""
    _, t_pred = predictors
    video = _video(n_frames, n_frames)
    np.testing.assert_allclose(stream_all(t_pred, video, SEQ_LEN, 0),
                               t_pred.predict_video(video), atol=OFFLINE_TOL, rtol=0)


def test_quality_mode_matches_center_stream(predictors):
    _, t_pred = predictors
    video = _video(5)
    for stride in (1, 3):
        np.testing.assert_allclose(stream_all(t_pred, video, stride, SEQ_LEN // 2),
                                   t_pred.predict_video(video, window_stride=stride),
                                   atol=OFFLINE_TOL, rtol=0)


def test_chunked_pushes_match_single_frames(predictors):
    _, t_pred = predictors
    video = _video(2, 17)
    a = stream_all(t_pred, video, 2, 3, chunk=1)
    for chunk in (5, 17):
        np.testing.assert_array_equal(stream_all(t_pred, video, 2, 3, chunk=chunk), a)


def test_short_stream_inside_lookahead(predictors):
    """A stream shorter than the lookahead gets every frame at flush."""
    j_pred, t_pred = predictors
    video = _video(3, 2)
    got = stream_all(t_pred, video, 3, 4)
    assert got.shape == (2, 17, 3)
    want = stream_all(j_pred, video, 3, 4)
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())))


def test_latency_and_validation(predictors):
    _, t_pred = predictors
    sess = t_pred.stream(stride=2, lookahead=3)
    assert isinstance(sess, StreamingSession)
    assert sess.latency_frames == 4
    assert t_pred.stream().lookahead == SEQ_LEN // 2
    with pytest.raises(ValueError, match="lookahead"):
        t_pred.stream(lookahead=SEQ_LEN)
    with pytest.raises(ValueError, match="lookahead"):
        t_pred.stream(lookahead=-1)
    with pytest.raises(ValueError, match="stride"):
        t_pred.stream(stride=SEQ_LEN, lookahead=1)
    with pytest.raises(ValueError, match="stride"):
        t_pred.stream(stride=0)
    with pytest.raises(ValueError, match="frames"):
        sess.push(np.zeros((3, 5, 2), np.float32))


def test_flush_closes_session(predictors):
    _, t_pred = predictors
    sess = t_pred.stream()
    assert sess.push(np.zeros((3, 17, 2), np.float32)).shape == (0, 17, 3)
    assert sess.flush().shape == (3, 17, 3)
    with pytest.raises(RuntimeError):
        sess.push(np.zeros((17, 2), np.float32))
    with pytest.raises(RuntimeError):
        sess.flush()
    empty = t_pred.stream()
    assert empty.flush().shape == (0, 17, 3)


def test_streaming_eval_matches_jax_tool(tmp_path, params, capsys):
    """The port's streaming_eval against tools/streaming_eval.py on a tiny
    FK-synthetic 3DHP archive, from one .pth: the offline anchor and the
    (lookahead, stride) grid, and the CSV."""
    sys.path.insert(0, str(ROOT / "tools"))
    import streaming_eval as j_streaming_eval

    from manipose_tpu_torch.tools import make_synthetic_3dhp, streaming_eval

    data = make_synthetic_3dhp.generate(tmp_path / "3dhp", train_seqs=1, cams=1,
                                        frames=20, test_frames=24, seed=1)
    pth = tmp_path / "model.pth"
    save_torch_checkpoint(pth, params, "rmcl_manifold")
    argv = ["--checkpoint", str(pth), "--dataset", "3dhp", "--lookaheads", "0", "4",
            "--strides", "1", "3", "--limit-frames", "12"]
    overrides = ["--", f"data.data_dir={data}", *OVERRIDES]
    want = j_streaming_eval.main(argv + overrides)
    got = streaming_eval.main(argv + ["--out", str(tmp_path / "stream.csv")]
                              + overrides + ["device=cpu"])
    assert [r["mode"] for r in got] == ["offline"] + ["stream"] * 4
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "mpjpe_mm"} == \
            {k: v for k, v in w.items() if k != "mpjpe_mm"}
        assert abs(g["mpjpe_mm"] - w["mpjpe_mm"]) <= STREAM_EVAL_TOL_MM + 1e-9, (g, w)
    lines = (tmp_path / "stream.csv").read_text().splitlines()
    assert lines[0] == "mode,lookahead,stride,latency_frames,mpjpe_mm"
    assert len(lines) == 1 + len(got)
