"""The port's CUDA kernels on the card: each against its plain version on
the same inputs (ragged edges, every head dim and channel count the
kernels take, strided and contiguous operands, fp32 and bf16), what the
wrappers refuse, and a small model and Predictor on the card against the
CPU. Marked ``cuda``; without a CUDA device every test skips. Run them on
the card with ``python -m pytest tests/test_torch_port_cuda.py -q
--noconftest``: tests/conftest.py sets up JAX for the rest of the suite,
and these tests need none of it.

Tolerances: attention 2e-5 and MLP 5e-5 in fp32 (the JAX package's own,
tests/test_pallas_attention.py and tests/test_pallas_mlp.py); 0.05 in bf16,
where kernel and plain version accumulate in fp32 from the same bf16
inputs and differ in the final rounding."""

import numpy as np
import pytest
import torch

from manipose_tpu_torch import ops
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.ops.cuda_attention import (
    attention_dense,
    attention_packed,
    attention_plain,
)
from manipose_tpu_torch.ops.cuda_mlp import fused_mlp, mlp_plain
from manipose_tpu_torch.serving import Predictor

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 5e-5), torch.bfloat16: (0.05, 0.05)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    """A seeded generator on the card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, h, n, d, dtype, strided):
    """q, k, v as (b, h, n, d): strided views of one (b, n, 3, h, d) qkv
    tensor, as the model's Attention builds them, or three contiguous
    tensors."""
    if strided:
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda")
        return [t.transpose(1, 2) for t in qkv.to(dtype).unbind(2)]
    return [torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def _max_err(a, b):
    torch.cuda.synchronize()
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,strided", [
    (2, 4, 243, 64, True), (3, 2, 100, 32, True), (2, 8, 243, 16, False),
    (1, 2, 129, 64, False), (2, 2, 5, 16, True), (2, 8, 243, 8, True),
])
def test_dense_kernel_matches_plain(gen, b, h, n, d, strided, dtype):
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided)
    got = attention_dense(q, k, v, d**-0.5)
    assert got.shape == (b, h, n, d) and got.dtype == dtype
    assert _max_err(got, attention_plain(q, k, v, d**-0.5)) <= TOL[dtype][0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,strided", [
    (48, 8, 17, 64, True), (37, 8, 16, 16, True), (5, 3, 32, 32, False),
    (3, 1, 1, 16, False), (9, 2, 7, 64, True), (40, 8, 17, 8, True),
])
def test_packed_kernel_matches_plain(gen, b, h, n, d, strided, dtype):
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided)
    got = attention_packed(q, k, v, d**-0.5)
    assert got.shape == (b, h, n, d) and got.dtype == dtype
    assert _max_err(got, attention_plain(q, k, v, d**-0.5)) <= TOL[dtype][0]


def _mlp_operands(gen, m, c, hidden, dtype):
    def uniform(shape, fan_in):
        u = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        return (u / fan_in**0.5).to(dtype)

    x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    return (x, uniform((hidden, c), c), uniform((hidden,), c),
            uniform((c, hidden), hidden), uniform((c,), hidden))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,hidden", [
    (1, 64, 128), (63, 128, 256), (1000, 256, 512), (130, 512, 1024),
    (64, 64, 64),
])
def test_mlp_kernel_matches_plain(gen, m, c, hidden, dtype):
    args = _mlp_operands(gen, m, c, hidden, dtype)
    got = fused_mlp(*args)
    assert got.shape == (m, c) and got.dtype == dtype
    assert _max_err(got, mlp_plain(*args)) <= TOL[dtype][1]


def test_mlp_kernel_matches_float64(gen):
    """Against an fp64 product on the CPU, not only the plain version."""
    args = _mlp_operands(gen, 333, 512, 1024, torch.float32)
    got = fused_mlp(*args).double().cpu()
    want = mlp_plain(*(a.double().cpu() for a in args))
    assert (got - want).abs().max().item() <= 5e-5


def test_kernels_refuse_what_they_do_not_take(gen):
    q, k, v = _qkv(gen, 2, 2, 17, 24, torch.float32, False)
    with pytest.raises(ValueError, match="head dim"):
        attention_dense(q, k, v, 1.0)
    q, k, v = _qkv(gen, 2, 2, 33, 16, torch.float32, False)
    with pytest.raises(ValueError, match="N <= 32"):
        attention_packed(q, k, v, 1.0)
    q, k, v = _qkv(gen, 2, 2, 17, 16, torch.float16, False)
    with pytest.raises(TypeError):
        attention_dense(q, k, v, 1.0)
    with pytest.raises(ValueError, match="share strides"):
        attention_dense(q.float(), k.float().contiguous(),
                        v.float().transpose(2, 3).contiguous().transpose(2, 3),
                        1.0)
    x, w1, b1, w2, b2 = _mlp_operands(gen, 10, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="channels"):
        fused_mlp(x[:, :48].contiguous(), w1[:, :48].contiguous(), b1,
                  w2[:48].contiguous(), b2[:48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp(x, w1, b1, w2.t().contiguous().t(), b2)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_mlp(x, w1.cpu(), b1, w2, b2)


# the model=small preset (64 channels in both trunks, 8 heads of 8), cut
# to 2 + 1 blocks, over full 243-frame windows so that the temporal layout
# reaches K1: per forward 2 + 1 dense and 2 + 1 per-window attention
# layers and 2 * (2 + 1) MLPs
OVERRIDES = ["model=small", "model.layers=2", "model.layers_seg=1",
             "multi_hyp.n_hyp=2"]
PER_FORWARD = {"attention_dense": 3, "attention_packed": 3, "fused_mlp": 6}


def test_predictor_on_card_matches_cpu(gen):
    cfg = load_config("config", OVERRIDES)
    card = Predictor(cfg=cfg, batch_size=2, tta=True)
    state = {k: v.cpu() for k, v in card.model.state_dict().items()}
    cpu = Predictor(cfg=cfg, batch_size=2, tta=True, state_dict=state,
                    device="cpu")
    video = np.random.default_rng(0).normal(size=(600, 17, 2))
    video = video.astype(np.float32)
    ops.reset_launch_counts()
    got = card.predict_video(video, return_hypotheses=True)
    n_batches = 2  # 3 windows of 243 frames in batches of 2
    assert ops.launch_counts() == {
        name: 2 * n * n_batches for name, n in PER_FORWARD.items()
    }
    want = cpu.predict_video(video, return_hypotheses=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        atol = 5e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
