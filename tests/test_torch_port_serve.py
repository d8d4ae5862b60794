"""The rest of the port's serving surface on the CPU: data-parallel
serving, the HTTP server (``manipose_tpu_torch/tools/serve.py``), the
predict CLI and ``export_model --verify``.

- ``serving.data_parallel_forward`` over four CPU replicas against one
  model within 2e-5 of the magnitude (each shard's products run at another
  batch size, so in another order), its "must divide" ``ValueError``, and
  a streaming session on a data-parallel predictor (each window
  replicated up to the batch) against a plain one's.
- The ``PoseServer`` cases of ``tests/test_serve.py`` on a port
  ``Predictor`` and on the JAX package's (``tools/serve.py``) with the
  same weights (sizes of ``tests/test_serving.py``, batch 2, TTA): each
  response equals the port's direct ``Predictor`` or session call
  exactly, and the JAX server's within 5e-5 of the magnitude (the JAX
  package's model-forward tolerance).
- ``python -m manipose_tpu_torch.tools.predict`` on an npz, as
  ``tests/test_tools.py`` runs ``tools/predict.py``, and
  ``python -m manipose_tpu_torch.tools.export_model --verify``, both in
  this process with ``device=cpu``.
"""

import json
import sys
import threading
from http.client import HTTPConnection
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
from manipose_tpu_torch import serving
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.ops import quant
from manipose_tpu_torch.serving import Predictor, data_parallel_forward
from manipose_tpu_torch.tools import export_model, predict
from manipose_tpu_torch.tools.serve import PoseServer, make_http_server
from manipose_tpu_torch.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

SEQ_LEN = 9
OVERRIDES = [
    f"data.seq_len={SEQ_LEN}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
TOL = 5e-5  # against the JAX package, of the output's magnitude
DP_TOL = 2e-5  # data-parallel shards against one model, of the magnitude
CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def servers():
    """The port's PoseServer and the JAX package's, on Predictors of the
    same weights (the JAX init perturbed from a numpy seed)."""
    from serve import PoseServer as JPoseServer

    model, _ = j_instantiate(j_load_config("config", OVERRIDES), h36m_skeleton_17())
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ_LEN, 17, 2), jnp.float32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    jax_server = JPoseServer(JPredictor(cfg=j_load_config("config", OVERRIDES),
                                        variables=params, batch_size=2, tta=True))
    port = PoseServer(Predictor(cfg=load_config("config", OVERRIDES), batch_size=2,
                                tta=True, state_dict=state_dict_from_jax(params,
                                                                         "rmcl_manifold"),
                                device="cpu"))
    return port, jax_server


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _both(servers, method, path, body):
    """(port status, port payload), the JAX server's status equal."""
    port, jax_server = servers
    status, out = port.handle(method, path, body)
    j_status, j_out = jax_server.handle(method, path, body)
    assert status == j_status, (out, j_out)
    return status, out, j_out


# ---------------------------------------------------------------- data parallel
def test_data_parallel_over_four_replicas_matches_one(servers):
    module = servers[0].predictor.serving_forward
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, SEQ_LEN, 17, 2)).astype(np.float32))
    with torch.no_grad():
        want = module(x)
        got = data_parallel_forward(module, CPU4)(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=DP_TOL * max(1.0, float(w.abs().max())))


def test_data_parallel_batch_must_divide(monkeypatch):
    forward = data_parallel_forward(torch.nn.Linear(2, 2), CPU4)
    with pytest.raises(ValueError, match="must divide"):
        forward(torch.zeros(6, 2))
    monkeypatch.setattr(serving, "local_devices", lambda device: CPU4)
    with pytest.raises(ValueError, match="must divide"):
        Predictor(cfg=load_config("config", OVERRIDES), batch_size=6, data_parallel=True,
                  device="cpu")


def test_stream_on_a_data_parallel_predictor(servers, monkeypatch):
    plain = servers[0].predictor
    monkeypatch.setattr(serving, "local_devices", lambda device: CPU4)
    state = plain.model.state_dict()
    dp = Predictor(cfg=plain.cfg, batch_size=4, tta=True, state_dict=state,
                   data_parallel=True, device="cpu")
    assert dp.data_parallel
    video = np.random.default_rng(1).normal(size=(20, 17, 2)).astype(np.float32)
    got, want = [], []
    for pred, out in ((dp, got), (plain, want)):
        sess = pred.stream(stride=2)
        out.append(np.concatenate([sess.push(video), sess.flush()], axis=0))
    assert got[0].shape == (20, 17, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=DP_TOL * max(1.0, float(np.abs(want[0]).max())))
    np.testing.assert_allclose(dp.predict_video(video), plain.predict_video(video), rtol=0,
                               atol=DP_TOL * max(1.0, float(np.abs(want[0]).max())))


# ---------------------------------------------------------------- PoseServer
def test_healthz(servers):
    status, out, _ = _both(servers, "GET", "/healthz", {})
    assert status == 200 and out["status"] == "ok"
    assert out["seq_len"] == SEQ_LEN and out["joints"] == 17
    assert out["device"] == "cpu" and not out["quantized"] and not out["data_parallel"]


def test_predict_matches_predictor(servers):
    kps = np.random.default_rng(0).normal(size=(13, 17, 2)).astype(np.float32)
    status, out, j_out = _both(servers, "POST", "/predict", {"keypoints": kps.tolist()})
    assert status == 200
    poses = np.asarray(out["poses"], np.float32)
    np.testing.assert_array_equal(poses, servers[0].predictor.predict_video(kps))
    _close(poses, j_out["poses"])


def test_predict_hypotheses(servers):
    kps = np.random.default_rng(1).normal(size=(9, 17, 2)).astype(np.float32)
    status, out, j_out = _both(servers, "POST", "/predict",
                               {"keypoints": kps.tolist(), "hypotheses": True})
    assert status == 200
    hyps = np.asarray(out["hypotheses"])
    assert hyps.shape == (1, 2, 9, 17, 3)  # (W, K, L, J, 3)
    np.testing.assert_allclose(np.asarray(out["scores"]).sum(axis=1), 1.0, atol=1e-5)
    for key in ("poses", "hypotheses", "scores"):
        _close(out[key], j_out[key])


def test_predict_window_stride(servers):
    kps = np.random.default_rng(3).normal(size=(12, 17, 2)).astype(np.float32)
    status, out, j_out = _both(servers, "POST", "/predict",
                               {"keypoints": kps.tolist(), "window_stride": 3})
    assert status == 200
    np.testing.assert_array_equal(np.asarray(out["poses"], np.float32),
                                  servers[0].predictor.predict_video(kps, window_stride=3))
    _close(out["poses"], j_out["poses"])
    status, out, _ = _both(servers, "POST", "/predict",
                           {"keypoints": kps.tolist(), "window_stride": 99})
    assert status == 400 and "window_stride" in out["error"]


def test_bad_requests(servers):
    """A bad shape, missing or mistyped fields are 400; an unknown route
    or session 404."""
    port, _ = servers
    status, out, _ = _both(servers, "POST", "/predict", {"keypoints": [[[0.0, 0.0]] * 5] * 3})
    assert status == 400 and "keypoints" in out["error"]
    status, out, _ = _both(servers, "POST", "/predict", {})
    assert status == 400 and "keypoints" in out["error"]
    assert _both(servers, "POST", "/nope", {})[0] == 404
    assert _both(servers, "POST", "/stream/deadbeef/push", {"frames": []})[0] == 404
    assert _both(servers, "POST", "/stream/open", {"stride": None})[0] == 400
    assert _both(servers, "POST", "/predict", {"keypoints": np.zeros((9, 17, 2)).tolist(),
                                               "window_stride": [3]})[0] == 400
    _, opened = port.handle("POST", "/stream/open", {})
    status, out = port.handle("POST", f"/stream/{opened['session']}/push", {})
    assert status == 400 and "frames" in out["error"]
    assert port.handle("POST", f"/stream/{opened['session']}/close", {})[0] == 200


def test_stream_lifecycle_matches_direct_session(servers):
    video = np.random.default_rng(2).normal(size=(20, 17, 2)).astype(np.float32)
    results = []
    for server in servers:
        status, opened = server.handle("POST", "/stream/open", {"stride": 3, "lookahead": 2})
        assert status == 200 and opened["latency_frames"] == 4
        sid, got = opened["session"], []
        for i in range(0, 20, 5):
            status, out = server.handle("POST", f"/stream/{sid}/push",
                                        {"frames": video[i:i + 5].tolist()})
            assert status == 200
            got.append(np.asarray(out["poses"], np.float32).reshape(-1, 17, 3))
        status, out = server.handle("POST", f"/stream/{sid}/flush", {})
        assert status == 200
        got.append(np.asarray(out["poses"], np.float32).reshape(-1, 17, 3))
        results.append(np.concatenate(got))
        # flush closed it
        assert server.handle("POST", f"/stream/{sid}/push",
                             {"frames": video[:1].tolist()})[0] == 404
    sess = servers[0].predictor.stream(stride=3, lookahead=2)
    np.testing.assert_array_equal(results[0],
                                  np.concatenate([sess.push(video), sess.flush()]))
    _close(results[0], results[1])


def test_session_cap_and_close(servers):
    port, _ = servers
    port.max_sessions = len(port.sessions) + 2
    try:
        sids = []
        for _ in range(2):
            status, out = port.handle("POST", "/stream/open", {})
            assert status == 200
            sids.append(out["session"])
        status, out = port.handle("POST", "/stream/open", {})
        assert status == 400 and "too many" in out["error"]
        status, out = port.handle("POST", f"/stream/{sids[0]}/close", {})
        assert status == 200 and out["closed"] == sids[0]
        assert port.handle("POST", "/stream/open", {})[0] == 200
    finally:
        port.max_sessions = 64
        port.sessions.clear()


@pytest.fixture
def http_port(servers):
    httpd = make_http_server(servers[0], "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_end_to_end_over_http(servers, http_port):
    conn = HTTPConnection("127.0.0.1", http_port, timeout=60)
    conn.request("GET", "/healthz")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    kps = np.random.default_rng(4).normal(size=(5, 17, 2)).astype(np.float32)
    conn.request("POST", "/predict", body=json.dumps({"keypoints": kps.tolist()}),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 200
    np.testing.assert_array_equal(np.asarray(json.loads(r.read())["poses"], np.float32),
                                  servers[0].predictor.predict_video(kps))
    conn.request("POST", "/predict", body="not json",
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 400 and "JSON" in json.loads(r.read())["error"]


def test_oversized_body_is_rejected_without_reading(http_port):
    """A Content-Length past the cap is answered 400 at once: the body is
    never read (here it is never sent)."""
    conn = HTTPConnection("127.0.0.1", http_port, timeout=30)
    conn.putrequest("POST", "/predict")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(8 << 30))
    conn.endheaders()
    r = conn.getresponse()
    assert r.status == 400 and "oversized" in json.loads(r.read())["error"]


# ---------------------------------------------------------------- the CLIs
@pytest.mark.parametrize("int8", [False, True])
def test_predict_cli_lifts_npz_videos(tmp_path, monkeypatch, capsys, int8):
    """Windowing, batch padding, TTA, the hypotheses and the npz output;
    the poses equal the port's Predictor of the same (seeded) weights."""
    monkeypatch.setattr(Predictor, "_int8_probe_cache", {})
    monkeypatch.setattr(quant, "int8_speedup", lambda **kw: 2.0)
    rng = np.random.default_rng(0)
    videos = {"clip_a": rng.normal(size=(40, 17, 2)).astype(np.float32),
              "clip_b": rng.normal(size=(13, 17, 2)).astype(np.float32)}
    np.savez(tmp_path / "kps.npz", **videos)
    out = tmp_path / "poses.npz"
    predict.main(["--input", str(tmp_path / "kps.npz"), "--output", str(out),
                  "--batch-size", "2", "--hypotheses"] + ["--int8"] * int8
                 + OVERRIDES + ["device=cpu"])
    assert "lifted 2 video(s)" in capsys.readouterr().out
    with np.load(out) as result:
        assert result["clip_a"].shape == (40, 17, 3)
        assert result["clip_b"].shape == (13, 17, 3)
        # ceil(40 / 9) = 5 windows, each with n_hyp = 2 hypotheses
        assert result["clip_a_hypotheses"].shape == (5, 2, 9, 17, 3)
        assert result["clip_a_scores"].shape == (5, 2, 9, 1)
        ref = Predictor(cfg=load_config("config", OVERRIDES), batch_size=2,
                        quantize="force" if int8 else False, device="cpu")
        np.testing.assert_array_equal(result["clip_a"], ref.predict_video(videos["clip_a"]))


def test_export_model_cli_verifies(tmp_path, capsys):
    out = tmp_path / "mixste.pt2"
    err = export_model.main(["--output", str(out), "--batch-size", "2", "--verify"]
                            + OVERRIDES + ["model.arch=mixste", "device=cpu"])
    printed = capsys.readouterr().out
    assert out.stat().st_size > 10_000 and "symbolic batch" in printed
    assert "verify: max |program - live|" in printed and err < export_model.VERIFY_TOL
