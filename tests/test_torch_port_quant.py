"""The port's int8 serving (``manipose_tpu_torch/ops/quant.py``) against
the JAX package's (``manipose_tpu/ops/quant.py``), on the CPU.

- ``quantize_weight`` equals ``quantize_kernel`` bit for bit, and
  ``quantize_state_dict(state_dict_from_jax(v))`` equals
  ``state_dict_from_jax(quantize_params(v))`` key for key.
- ``QuantLinear`` against ``QuantDense`` on the same input: the int8 codes
  equal; the output within 1e-6 relative in fp32 (the same int32 sums,
  dequantized in the same order) and within one bf16 ulp in bf16 (one
  rounding of nearly the same fp32 value).
- The int8 ``Predictor`` against the JAX int8 ``Predictor`` on the same
  float weights (``quantize="force"``, the sizes of
  ``tests/test_serving.py``). The two trunks' fp32 sums run in another
  order on each side, so an activation sitting on a rounding boundary of
  its int8 code can land on either code, which moves the output by a
  quantization step, far more than fp32 rounding does. The bound is
  therefore 2 * spread + 5e-5 of the magnitude, where spread is how far
  the JAX int8 predictor's own poses move when its input moves by one fp32
  ulp (the same kind of code flips); the test prints it.
- The int8 port within 0.2 relative of the float port
  (``tests/test_serving.py``'s bound), the probe's gate
  (``TestInt8Gating`` of ``tests/test_serving.py``, the probe
  monkeypatched), ``from_checkpoint`` on a port run directory, and
  ``quant.int_mm``'s zero-padding exact at widths ``_int_mm`` refuses on
  the card (C=16/H=32 models, ragged k and n, few rows).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.geometry import h36m_skeleton_17
from manipose_tpu.ops.quant import QuantDense, quantize_kernel, quantize_params
from manipose_tpu.serving import Predictor as JPredictor
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.ops import quant
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.weights import state_dict_from_jax

SEQ_LEN = 9
OVERRIDES = [
    f"data.seq_len={SEQ_LEN}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]
TOL = 5e-5  # model-forward tolerance, of the output's magnitude
ARCH = "rmcl_manifold"


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
    """The JAX model's float init, perturbed from a numpy seed so that no
    weight sits at an init constant."""
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
    """The JAX int8 Predictor, the port's int8 and float Predictors, all
    from the same float weights, batch 3, TTA on."""
    j_q = JPredictor(cfg=j_load_config("config", OVERRIDES), variables=params,
                     batch_size=3, tta=True, quantize="force")
    kw = dict(cfg=load_config("config", OVERRIDES), batch_size=3, tta=True,
              state_dict=state_dict_from_jax(params, ARCH), device="cpu")
    return j_q, Predictor(quantize="force", **kw), Predictor(**kw)


def _cfg():
    return load_config("config", OVERRIDES)


def test_quantize_weight_equals_quantize_kernel():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 40)).astype(np.float32)  # (in, out)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    w[:, 5] *= 1e-3
    want_q, want_scale = quantize_kernel(w)
    got_q, got_scale = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8 and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().T, want_q)
    np.testing.assert_array_equal(got_scale.numpy(), want_scale)


def _quant_dense(x, w_q, scale, bias, dtype):
    """QuantDense on (in, out) int8 weights; its activation codes by its
    own formula (``quant.py:60-63``)."""
    variables = {"params": {"kernel_q": jnp.asarray(w_q), "scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}}
    y = QuantDense(w_q.shape[1], dtype=dtype).apply(variables, x)
    x32 = x.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-8)
    codes = jnp.clip(jnp.round(x32 / a_scale), -127, 127).astype(jnp.int8)
    return np.asarray(y.astype(jnp.float32)), np.asarray(codes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_linear_matches_quant_dense(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 17, 48)).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero row takes the 1e-8 floor
    w_q, scale = quantize_kernel(rng.normal(size=(48, 40)).astype(np.float32))
    bias = rng.normal(size=(40,)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want, want_codes = _quant_dense(jnp.asarray(x, jdt), w_q, scale, bias, jdt)

    layer = quant.QuantLinear(48, 40, compute_dtype=tdt)
    layer.load_state_dict({"weight_q": torch.from_numpy(w_q.T.copy()),
                           "scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).to(tdt)
    codes, _ = quant.quantize_rows(xt)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    got = layer(xt)
    assert got.dtype == tdt and got.shape == (2, 17, 40)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("arch", ["rmcl_manifold", "mixste"])
def test_quantize_state_dict_matches_quantize_params(arch):
    model, _ = j_instantiate(j_load_config("config", OVERRIDES + [f"model.arch={arch}"]),
                             h36m_skeleton_17())
    v = jax.jit(model.init)(jax.random.PRNGKey(1),
                            jnp.zeros((1, SEQ_LEN, 17, 2), jnp.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, quantize_params(v)), arch)
    got = quant.quantize_state_dict(state_dict_from_jax(v, arch))
    assert list(got) == list(want)
    assert sum(k.endswith(".weight_q") for k in got) == 4 * (2 + 2) * (
        2 if arch == "rmcl_manifold" else 1)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # a quantized state dict maps to itself
    again = quant.quantize_state_dict(got)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_quant_model_layout_loads_strict():
    """The quant model's state dict has exactly the quantized keys, so a
    quantized state dict loads into it with strict=True."""
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton

    floats, _ = instantiate_model(_cfg(), t_skeleton())
    qmodel, _ = instantiate_model(_cfg(), t_skeleton(), quant=True)
    sd = quant.quantize_state_dict(floats.state_dict())
    assert set(qmodel.state_dict()) == set(sd)
    qmodel.load_state_dict(sd, strict=True)
    assert not any(isinstance(m, torch.nn.Linear) and "mlp" in n
                   for n, m in qmodel.named_modules())


def test_int8_predictor_matches_jax(predictors):
    j_q, t_q, _ = predictors
    video = np.random.default_rng(2).normal(size=(20, 17, 2)).astype(np.float32)
    want = j_q.predict_video(video)
    spread = float(np.abs(j_q.predict_video(np.nextafter(video, np.float32(np.inf)))
                          - want).max())
    got = t_q.predict_video(video)
    err = float(np.abs(got - want).max())
    tol = 2 * spread + TOL * max(1.0, float(np.abs(want).max()))
    print(f"int8 port vs JAX: max err {err:.3g}, the JAX int8 predictor's one-ulp "
          f"spread {spread:.3g}, tol {tol:.3g}")
    assert got.shape == want.shape == (20, 17, 3)
    assert err <= tol


def test_int8_port_is_close_to_the_float_port(predictors):
    _, t_q, t_fp = predictors
    assert t_q.quantized and not t_fp.quantized
    video = np.random.default_rng(0).normal(size=(20, 17, 2)).astype(np.float32)
    p_q, p_fp = t_q.predict_video(video), t_fp.predict_video(video)
    assert p_q.shape == p_fp.shape == (20, 17, 3) and np.isfinite(p_q).all()
    rel = np.linalg.norm(p_q - p_fp) / (np.linalg.norm(p_fp) + 1e-9)
    assert rel < 0.2, rel


class TestInt8Gating:
    """``quantize=True`` measures the int8-vs-bf16 GEMM rate once per
    process and device type and stays on the float path, with a warning,
    below 1.05."""

    @pytest.fixture(autouse=True)
    def fresh_cache(self, monkeypatch):
        monkeypatch.setattr(Predictor, "_int8_probe_cache", {})

    def test_falls_back_when_int8_not_faster(self, monkeypatch):
        monkeypatch.setattr(quant, "int8_speedup", lambda **kw: 0.95)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = Predictor(cfg=_cfg(), batch_size=2, tta=False, quantize=True, device="cpu")
        assert not p.quantized
        assert any("not faster" in str(w.message) for w in caught)
        # the float path still serves
        assert p.predict_video(np.zeros((9, 17, 2), np.float32)).shape == (9, 17, 3)

    def test_quantizes_when_int8_wins(self, monkeypatch):
        monkeypatch.setattr(quant, "int8_speedup", lambda **kw: 1.8)
        p = Predictor(cfg=_cfg(), batch_size=2, tta=False, quantize=True, device="cpu")
        assert p.quantized
        assert any(isinstance(m, quant.QuantLinear) for m in p.model.modules())

    def test_force_skips_probe(self, monkeypatch):
        def boom(**kw):
            raise AssertionError("probe must not run under force")

        monkeypatch.setattr(quant, "int8_speedup", boom)
        p = Predictor(cfg=_cfg(), batch_size=2, tta=False, quantize="force", device="cpu")
        assert p.quantized

    def test_probe_runs_once_per_process(self, monkeypatch):
        calls = []

        def probe(**kw):
            calls.append(kw["device"])
            return 1.8

        monkeypatch.setattr(quant, "int8_speedup", probe)
        for _ in range(2):
            Predictor(cfg=_cfg(), batch_size=2, tta=False, quantize=True, device="cpu")
        assert calls == [torch.device("cpu")]


def test_from_checkpoint_quantizes_a_port_run(tmp_path, predictors):
    """A run directory of the port's training loop holds float weights;
    ``quantize="force"`` quantizes them after loading."""
    _, t_q, t_fp = predictors
    (tmp_path / "best_val").mkdir()
    torch.save({"model_pos": t_fp.model.state_dict()}, tmp_path / "best_val" / "model.pth")
    loaded = Predictor.from_checkpoint(tmp_path, cfg=_cfg(), batch_size=3,
                                       quantize="force", device="cpu")
    assert loaded.quantized
    for k, v in t_q.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    video = np.random.default_rng(3).normal(size=(12, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict_video(video), t_q.predict_video(video))


@pytest.mark.parametrize("m,k,n", [(5, 16, 32), (100, 32, 16), (7, 12, 20), (17, 20, 36)])
def test_int_mm_padding_is_exact(m, k, n):
    """Rows under 17, and k or n not a multiple of 8, are zero-padded up
    to what ``torch._int_mm`` takes on the card; the product equals the
    exact int32 one."""
    gen = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    got = quant.int_mm(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    torch.testing.assert_close(got, a.int() @ w.int().t(), rtol=0, atol=0)
