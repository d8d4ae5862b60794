"""The port's CUDA kernels on the card: each forward (K1, K3, K5) and
backward (K2, K4, K6) kernel against its plain version on the same inputs
(ragged edges, every head dim and channel count the kernels take, strided
and contiguous operands, fp32 and bf16), K1/K2 at every N around their
tiles and K3/K4 at every N they take and at window counts around their
persistent walk, both pairs against fp64 and, for K2 and K4, run twice for
bit-for-bit equality, what the wrappers refuse, the autograd Functions
against autograd through the plain versions, head dims and MLP widths the
kernels take zero-padded, and a small model's Predictor and train step on
the card against the CPU, in fp32 and under bf16 compute (with each
kernel's launches counted on bf16 operands), the flagship model's
bf16 forward on one window, K3-K6 at the 3DHP model's shapes (L = 27,
batch 25), the 3DHP test protocol and a streaming session on the card
against the CPU, the int8 predictor on the card against the CPU, an
exported program on the card, a data-parallel predictor on one card, K3/K4
on the joint-major layout's strided windows, a joint-major model against
the fold layout, the megastep's CUDA graph against single steps (with and
without remat), and a remat step against the plain one.
Marked ``cuda``; without a CUDA device every test skips. Run them on the
card with ``python -m pytest tests/test_torch_port_cuda.py -q
--noconftest``: tests/conftest.py sets up JAX for the rest of the suite,
and these tests need none of it.

Tolerances: forward attention 2e-5 and MLP 5e-5 in fp32 (the JAX
package's own, tests/test_pallas_attention.py and tests/test_pallas_mlp.py);
0.05 in bf16, where kernel and plain version accumulate in fp32 from the
same bf16 inputs and differ in the final rounding. Gradients: the JAX
package's 5e-4 (attention) and 5e-4 * max(1, |ref|max) (MLP) in fp32;
0.05 * max(1, |ref|max) in bf16."""

from pathlib import Path

import numpy as np
import pytest
import torch

from manipose_tpu_torch import ops
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.ops.cuda_attention import (
    attention,
    attention_dense,
    attention_dense_bwd,
    attention_packed,
    attention_packed_bwd,
    attention_plain,
    attention_plain_bwd,
    packed_launch_shape,
)
from manipose_tpu_torch.ops.cuda_attention import merge_heads, split_heads
from manipose_tpu_torch.ops.cuda_mlp import (
    fused_mlp,
    fused_mlp_bwd,
    mlp_forward,
    mlp_plain,
    mlp_plain_bwd,
)
from manipose_tpu_torch.ops.probes.run_probes import bf16_attention_errors
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.train import (
    LossConfig,
    TrainState,
    make_optimizer,
    make_train_step,
)

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


# ragged M around the kernels' 64-row and 128-row tiles at every channel
# count, with a hidden width that is an odd multiple of 64 where it can be
# (the weight sums' 128-wide tiles then end half full)
RAGGED_MLP_SHAPES = [(m, c, hidden) for m in (1, 65, 129, 4097)
                     for c, hidden in ((64, 192), (128, 320), (256, 512),
                                       (512, 1024))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,hidden", [
    (1, 64, 128), (63, 128, 256), (1000, 256, 512), (130, 512, 1024),
    (64, 64, 64),
] + RAGGED_MLP_SHAPES)
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
    # K5 itself takes only its built widths; fused_mlp pads up to them
    with pytest.raises(ValueError, match="channels"):
        mlp_forward(x[:, :48].contiguous(), w1[:, :48].contiguous(), b1,
                    w2[:48].contiguous(), b2[:48].contiguous())
    with pytest.raises(ValueError, match="channels"):  # past the widest
        fused_mlp(*_mlp_operands(gen, 10, 576, 128, torch.float32))
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
        **{name: 0 for name in PER_BACKWARD},
        **{name: 2 * n * n_batches for name, n in PER_FORWARD.items()},
    }
    want = cpu.predict_video(video, return_hypotheses=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        atol = 5e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# ---- backward kernels K2, K4, K6 ------------------------------------------

GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 0.05}


def _grad_tol(ref, dtype, relative: bool):
    scale = max(1.0, ref.float().abs().max().item())
    return GRAD_TOL[dtype] * (scale if relative or dtype == torch.bfloat16 else 1.0)


def _dout_like(gen, out):
    """A gradient with the (B, h, N, d) strides of the kernels' outputs."""
    b, h, n, d = out.shape
    g = torch.randn((b, n, h, d), generator=gen, device="cuda")
    return g.to(out.dtype).transpose(1, 2)


def _plain_dqkv(q, k, v, dout, scale):
    return torch.stack([g.transpose(1, 2)
                        for g in attention_plain_bwd(q, k, v, dout, scale)], dim=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,strided", [
    (2, 8, 243, 64, True), (3, 2, 128, 32, True), (2, 8, 243, 16, False),
    (2, 4, 17, 64, True), (1, 2, 129, 8, False), (2, 8, 243, 8, True),
    (4, 2, 100, 16, True),
])
def test_dense_bwd_kernel_matches_plain(gen, b, h, n, d, strided, dtype):
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided)
    scale = d**-0.5
    lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
    out = attention_dense(q, k, v, scale, lse=lse)
    dout = _dout_like(gen, out)
    got = attention_dense_bwd(q, k, v, out, dout, lse, scale)
    want = _plain_dqkv(q, k, v, dout, scale)
    assert got.shape == (b, n, 3, h, d) and got.dtype == dtype
    assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 8])
@pytest.mark.parametrize("n", [1, 15, 16, 63, 64, 65, 127, 243, 256])
def test_dense_kernels_at_tile_edges(gen, n, d, dtype):
    """K1 (output and log-sum-exp) and K2 at every N around the 16-row warp
    tiles and 64-row block tiles; d = 8 in bf16 pads each row to one
    16-wide k-step."""
    b, h = 2, 3
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided=True)
    scale = d**-0.5
    lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
    out = attention_dense(q, k, v, scale, lse=lse)
    assert _max_err(out, attention_plain(q, k, v, scale)) <= TOL[dtype][0]
    exact = torch.logsumexp(scale * q.double() @ k.double().transpose(-1, -2), -1)
    assert _max_err(lse, exact) <= 1e-5 * max(1.0, exact.abs().max().item())
    dout = _dout_like(gen, out)
    got = attention_dense_bwd(q, k, v, out, dout, lse, scale)
    want = _plain_dqkv(q, k, v, dout, scale)
    assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)


@pytest.mark.parametrize("n,d", [(243, 64), (243, 16), (100, 32)])
def test_dense_kernels_match_float64(gen, n, d):
    """K1 and K2 in fp32 (3xTF32 on the tensor cores) against attention and
    its autograd gradient in fp64 on the CPU, within the JAX package's 2e-5
    and 5e-4."""
    b, h = 2, 4
    q, k, v = _qkv(gen, b, h, n, d, torch.float32, strided=True)
    scale = d**-0.5
    lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
    out = attention_dense(q, k, v, scale, lse=lse)
    dout = _dout_like(gen, out)
    got = attention_dense_bwd(q, k, v, out, dout, lse, scale)
    leaves = [t.double().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.softmax(scale * leaves[0] @ leaves[1].transpose(-1, -2), -1) @ leaves[2]
    grads = torch.autograd.grad(want, leaves, dout.double().cpu())
    assert (out.double().cpu() - want.detach()).abs().max().item() <= 2e-5
    want_dqkv = torch.stack([g.transpose(1, 2) for g in grads], dim=2)
    assert (got.double().cpu() - want_dqkv).abs().max().item() <= 5e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_bwd_kernel_is_deterministic(gen, dtype):
    """K2 uses no atomics: every row of dQ, dK and dV is summed by one warp
    in a fixed order, so two runs agree bit for bit."""
    q, k, v = _qkv(gen, 4, 8, 243, 64, dtype, strided=True)
    lse = torch.empty((4, 8, 243), dtype=torch.float32, device="cuda")
    out = attention_dense(q, k, v, 0.125, lse=lse)
    dout = _dout_like(gen, out)
    first = attention_dense_bwd(q, k, v, out, dout, lse, 0.125)
    second = attention_dense_bwd(q, k, v, out, dout, lse, 0.125)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,strided", [
    (48, 8, 17, 64, True), (37, 8, 16, 16, True), (5, 3, 32, 32, False),
    (3, 1, 1, 16, False), (9, 2, 7, 64, True), (40, 8, 17, 8, True),
])
def test_packed_bwd_kernel_matches_plain(gen, b, h, n, d, strided, dtype):
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided)
    scale = d**-0.5
    dout = _dout_like(gen, attention_packed(q, k, v, scale))
    got = attention_packed_bwd(q, k, v, dout, scale)
    want = _plain_dqkv(q, k, v, dout, scale)
    assert got.shape == (b, n, 3, h, d) and got.dtype == dtype
    assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)


def _packed_check(q, k, v, dout, scale, dtype):
    """K3 and K4 against their plain versions on the same inputs."""
    assert _max_err(attention_packed(q, k, v, scale),
                    attention_plain(q, k, v, scale)) <= TOL[dtype][0]
    want = _plain_dqkv(q, k, v, dout, scale)
    got = attention_packed_bwd(q, k, v, dout, scale)
    assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("n", range(1, 33))
def test_packed_kernels_at_every_window_size(gen, n, d, dtype):
    """K3 and K4 at every N the per-window kernels take: one or two 16-row
    query tiles, 1 to 4 key tiles of 8, bf16 k-steps of 16 keys half
    empty, and rows past N read from the zero row."""
    b, h = 3, 5
    q, k, v = _qkv(gen, b, h, n, d, dtype, strided=True)
    dout = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    _packed_check(q, k, v, dout, d**-0.5, dtype)


def _grid_warps(dtype, d, n, backward):
    shape = packed_launch_shape(dtype, d, n, backward, 1 << 30)
    return shape["blocks"] * shape["warps"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backward", [False, True])
def test_packed_kernels_around_the_persistent_walk(gen, backward, dtype):
    """Window counts around the grid's warps: one window, one warp short
    of a window each, one window more than the warps (a second lap for one
    warp), and several windows a warp, so the ring's prologue, refills and
    empty commits all run."""
    n, d = 17, 64
    warps = _grid_warps(dtype, d, n, backward)
    for windows in (1, warps - 1, warps + 1, 3 * warps + 5):
        q, k, v = _qkv(gen, windows, 1, n, d, dtype, strided=True)
        dout = torch.randn((windows, n, 1, d), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)
        if backward:
            want = _plain_dqkv(q, k, v, dout, d**-0.5)
            got = attention_packed_bwd(q, k, v, dout, d**-0.5)
            assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)
        else:
            assert _max_err(attention_packed(q, k, v, d**-0.5),
                            attention_plain(q, k, v, d**-0.5)) <= TOL[dtype][0]


def test_packed_launch_shape_fills_the_card(gen):
    """Every dtype and head dim at the flagship's windows launches at
    least one block an SM and no more blocks than the card holds at once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in DTYPES:
        for d in (8, 16, 32, 64):
            for n, backward in ((17, False), (17, True), (16, False), (16, True)):
                shape = packed_launch_shape(dtype, d, n, backward, 1 << 30)
                assert shape["blocks_per_sm"] >= 1
                assert shape["blocks"] == sms * shape["blocks_per_sm"]
                assert shape["smem_bytes"] * shape["blocks_per_sm"] <= 228 * 1024


@pytest.mark.parametrize("n,d", [(17, 64), (16, 16), (32, 32), (5, 8)])
def test_packed_kernels_match_float64(gen, n, d):
    """K3 and K4 in fp32 (3xTF32 on the tensor cores) against attention and
    its autograd gradient in fp64 on the CPU, within the JAX package's 2e-5
    and 5e-4."""
    b, h = 40, 8
    q, k, v = _qkv(gen, b, h, n, d, torch.float32, strided=True)
    scale = d**-0.5
    out = attention_packed(q, k, v, scale)
    dout = _dout_like(gen, out)
    got = attention_packed_bwd(q, k, v, dout, scale)
    leaves = [t.double().cpu().requires_grad_() for t in (q, k, v)]
    want = torch.softmax(scale * leaves[0] @ leaves[1].transpose(-1, -2), -1) @ leaves[2]
    grads = torch.autograd.grad(want, leaves, dout.double().cpu())
    assert (out.double().cpu() - want.detach()).abs().max().item() <= 2e-5
    want_dqkv = torch.stack([g.transpose(1, 2) for g in grads], dim=2)
    assert (got.double().cpu() - want_dqkv).abs().max().item() <= 5e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_bwd_kernel_is_deterministic(gen, dtype):
    """K4 uses no atomics: one warp owns every output of a window and sums
    it in a fixed order, so two runs agree bit for bit."""
    q, k, v = _qkv(gen, 300, 8, 17, 64, dtype, strided=True)
    dout = _dout_like(gen, attention_packed(q, k, v, 0.125))
    first = attention_packed_bwd(q, k, v, dout, 0.125)
    second = attention_packed_bwd(q, k, v, dout, 0.125)
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,hidden", [
    (1, 64, 128), (63, 128, 256), (1000, 256, 512), (130, 512, 1024),
    (64, 64, 64), (5000, 128, 256),
] + RAGGED_MLP_SHAPES)
def test_mlp_bwd_kernel_matches_plain(gen, m, c, hidden, dtype):
    x, w1, b1, w2, _ = _mlp_operands(gen, m, c, hidden, dtype)
    g = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    got = fused_mlp_bwd(x, w1, b1, w2, g)
    want = mlp_plain_bwd(x, w1, b1, w2, g)
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert _max_err(a, r) <= _grad_tol(r, dtype, relative=True), name


def test_mlp_bwd_kernel_matches_float64(gen):
    """dX, dW1 and dW2 (3xTF32 on the card) against the plain backward in
    fp64 on the CPU, within 5e-4 * max(1, |ref|max)."""
    x, w1, b1, w2, _ = _mlp_operands(gen, 3000, 512, 1024, torch.float32)
    g = torch.randn((3000, 512), generator=gen, device="cuda")
    got = fused_mlp_bwd(x, w1, b1, w2, g)
    want = mlp_plain_bwd(*(t.double().cpu() for t in (x, w1, b1, w2, g)))
    for name, i in (("dx", 0), ("dw1", 1), ("dw2", 3)):
        tol = 5e-4 * max(1.0, want[i].abs().max().item())
        err = (got[i].double().cpu() - want[i]).abs().max().item()
        assert err <= tol, name


def test_mlp_bwd_kernel_is_deterministic(gen):
    """The weight sums run over a fixed split of M with no atomics."""
    x, w1, b1, w2, _ = _mlp_operands(gen, 3000, 512, 1024, torch.float32)
    g = torch.randn((3000, 512), generator=gen, device="cuda")
    first = fused_mlp_bwd(x, w1, b1, w2, g)
    second = fused_mlp_bwd(x, w1, b1, w2, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_kernels_refuse_what_they_do_not_take(gen):
    q, k, v = _qkv(gen, 2, 2, 17, 24, torch.float32, False)
    with pytest.raises(ValueError, match="head dim"):
        attention_packed_bwd(q, k, v, q, 1.0)
    q, k, v = _qkv(gen, 2, 2, 33, 16, torch.float32, False)
    with pytest.raises(ValueError, match="N <= 32"):
        attention_packed_bwd(q, k, v, q, 1.0)
    q, k, v = _qkv(gen, 2, 2, 40, 16, torch.float32, True)
    lse = torch.empty((2, 2, 40), device="cuda")
    out = attention_dense(q, k, v, 1.0, lse=lse)
    with pytest.raises(ValueError, match="lse"):
        attention_dense_bwd(q, k, v, out, _dout_like(gen, out), lse[:, :, :20], 1.0)
    with pytest.raises(ValueError, match="out and dout"):
        attention_dense_bwd(q, k, v, out, out.contiguous(), lse, 1.0)
    x, w1, b1, w2, _ = _mlp_operands(gen, 10, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="g must be"):
        fused_mlp_bwd(x, w1, b1, w2, x.t().contiguous().t())
    with pytest.raises(ValueError, match="channels"):
        fused_mlp_bwd(x[:, :48].contiguous(), w1[:, :48].contiguous(), b1,
                      w2[:48].contiguous(), x[:, :48].contiguous())


@pytest.mark.parametrize("n,d", [(243, 64), (17, 64), (16, 16)])
def test_attention_function_matches_autograd_of_plain(gen, n, d):
    """The Function's gradient of the qkv tensor (K1 + K2, or K3 + K4)
    against autograd through the plain version on the CPU."""
    b, h = 3, 4
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda")
    w = torch.randn((b, n, h * d), generator=gen, device="cuda")
    card = qkv.clone().requires_grad_()
    (attention(card, h, d**-0.5) * w).sum().backward()
    cpu = qkv.cpu().requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in cpu.view(b, n, 3, h, d).unbind(2))
    out = attention_plain(q, k, v, d**-0.5).transpose(1, 2).reshape(b, n, h * d)
    (out * w.cpu()).sum().backward()
    assert _max_err(card.grad.cpu(), cpu.grad) <= 5e-4


def test_dense_attention_writes_lse_only_for_a_gradient(gen, monkeypatch):
    """Serving (no gradient wanted) pays for no log-sum-exp; a
    differentiable call asks K1 for one."""
    from manipose_tpu_torch.ops import cuda_attention as ca

    asked = []
    kernel = ca.attention_dense

    def spy(q, k, v, scale, lse=None):
        asked.append(lse is not None)
        return kernel(q, k, v, scale, lse=lse)

    monkeypatch.setattr(ca, "attention_dense", spy)
    qkv = torch.randn((2, 243, 3 * 4 * 16), generator=gen, device="cuda")
    attention(qkv, 4, 0.25)
    qkv.requires_grad_()
    with torch.no_grad():
        attention(qkv, 4, 0.25)
    with torch.inference_mode():
        attention(qkv.detach(), 4, 0.25)
    attention(qkv, 4, 0.25)
    assert asked == [False, False, False, True]


def test_mlp_function_matches_autograd_of_plain(gen):
    args = _mlp_operands(gen, 700, 128, 256, torch.float32)
    w = torch.randn((700, 128), generator=gen, device="cuda")
    card = [a.clone().requires_grad_() for a in args]
    (fused_mlp(*card) * w).sum().backward()
    cpu = [a.cpu().requires_grad_() for a in args]
    (mlp_plain(*cpu) * w.cpu()).sum().backward()
    for a, r in zip(card, cpu):
        tol = 5e-4 * max(1.0, r.grad.abs().max().item())
        assert _max_err(a.grad.cpu(), r.grad) <= tol


# ---- shapes the kernels are not built for, zero-padded up ------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [16, 17, 243])
def test_head_dim_4_runs_the_kernels_padded(gen, n, dtype):
    """Head dim 4 (the segments trunk of tools/h36m_head_to_head.py) runs
    K3/K4 (N <= 32) or K1/K2 padded to 8, forward and backward, against
    autograd through the plain version on the same inputs."""
    b, h, d, scale = 3, 4, 4, 0.5
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((b, n, h * d), generator=gen, device="cuda")
    ops.reset_launch_counts()
    card = qkv.clone().requires_grad_()
    out = attention(card, h, scale)
    (out.float() * w).sum().backward()
    kind = "attention_packed" if n <= 32 else "attention_dense"
    counts = ops.launch_counts(dtype)
    assert counts[kind] == 1 and counts[f"{kind}_bwd"] == 1
    ref = qkv.clone().requires_grad_()
    want = merge_heads(attention_plain(*split_heads(ref, h), scale))
    (want.float() * w).sum().backward()
    assert out.shape == want.shape and out.dtype == dtype
    assert _max_err(out, want) <= TOL[dtype][0]
    assert _max_err(card.grad, ref.grad) <= _grad_tol(ref.grad, dtype, relative=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hidden", [(16, 32), (32, 64)])
def test_narrow_mlp_runs_the_kernels_padded(gen, c, hidden, dtype):
    """MLP widths C 16 / H 32 (tools/h36m_head_to_head.py) and C 32 / H 64
    (tools/mup_coord_check.py) run K5/K6 padded to C 64, H 64, forward and
    backward, against autograd through the plain version."""
    args = _mlp_operands(gen, 700, c, hidden, dtype)
    w = torch.randn((700, c), generator=gen, device="cuda")
    ops.reset_launch_counts()
    card = [a.clone().requires_grad_() for a in args]
    out = fused_mlp(*card)
    (out.float() * w).sum().backward()
    counts = ops.launch_counts(dtype)
    assert counts["fused_mlp"] == 1 and counts["fused_mlp_bwd"] == 1
    ref = [a.clone().requires_grad_() for a in args]
    want = mlp_plain(*ref)
    (want.float() * w).sum().backward()
    assert out.shape == (700, c) and out.dtype == dtype
    assert _max_err(out, want) <= TOL[dtype][1]
    for a, r in zip(card, ref):
        assert a.grad.dtype == dtype
        assert _max_err(a.grad, r.grad) <= _grad_tol(r.grad, dtype, relative=True)


# backward launches per train step of the OVERRIDES model: one per forward
# kernel launch
PER_BACKWARD = {"attention_dense_bwd": 3, "attention_packed_bwd": 3,
                "fused_mlp_bwd": 6}


def test_train_step_on_card_matches_cpu(gen):
    """One fp32 train step (drop-path off) of a small model on the card and
    on the CPU from the same weights: losses and every gradient."""
    cfg = load_config("config", OVERRIDES + ["model.drop_path_rate=0.0"])
    skeleton = h36m_skeleton_17()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 243, 17, 2)).astype(np.float32)
    y = 0.1 * rng.normal(size=(2, 243, 17, 3)).astype(np.float32)
    metrics, grads = {}, {}
    for device in ("cpu", "cuda"):
        model, _ = instantiate_model(cfg, skeleton)
        opt = make_optimizer(model.parameters(), weight_decay=1e-6)
        state = TrainState.create(model, opt, seed=0, device=device)
        step = make_train_step(model, LossConfig(), skeleton, opt)
        ops.reset_launch_counts()
        metrics[device] = {k: v.item() for k, v in step(state, x, y, 4e-5).items()}
        if device == "cuda":
            assert ops.launch_counts() == {**PER_FORWARD, **PER_BACKWARD}
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    for k, want in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - want) <= 5e-5 * max(1.0, abs(want)), k
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert torch.isfinite(got).all(), name
        tol = 5e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, name


# ---- bf16 compute (model.dtype=bfloat16) ------------------------------------

# the JAX package's bf16 model tolerance, relative to max(1, |ref|max), and
# relative in norm for gradients; the FK-decoded poses take the larger of it
# and 2 * the CPU's own spread under a one-ulp input nudge + 1e-3, since the
# decoder's Gram-Schmidt amplifies bf16 rounding at random weights (see
# chip_smoke.py)
BF16_TOL = 0.05
GAP_SLACK = 1e-3
BF16_NUDGE = 1.0 + 2.0**-8


def _rel(got, ref):
    """max |got - ref| over max(1, |ref|max)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _bf16_model(cfg, weights, device):
    model, _ = instantiate_model(cfg, h36m_skeleton_17())
    model.load_state_dict(weights)
    return model.to(device).train()


def _branch_grads(cfg, weights, x, device):
    """Gradients of both branches' outputs under a fixed random cotangent
    (CPU seed 0): every kernel forward and backward, without FK and the WTA
    loss."""
    model = _bf16_model(cfg, weights, device)
    xt = torch.from_numpy(x).to(device)
    hyps, scores = model.rotations_module(xt)
    gen = torch.Generator().manual_seed(0)
    total = sum((t.float() * torch.randn(t.shape, generator=gen).to(device)).sum()
                for t in (hyps, scores, model.segments_module(xt)))
    total.backward()
    return {n: p.grad.cpu() for n, p in model.named_parameters()}


def test_bf16_train_step_on_card_matches_cpu(gen):
    """One train step of the small model under model.dtype=bfloat16: every
    kernel launched on bf16 operands and none on fp32, the loss terms within
    0.05 relative, every gradient fp32 and finite; each parameter's gradient
    of the branches' outputs within 0.05 relative in norm (the step's own
    gradients pass through FK and the WTA loss, which a 1e-3 change of the
    input moves by half at random weights: they are required finite)."""
    cfg = load_config("config", OVERRIDES + ["model.drop_path_rate=0.0",
                                             "model.dtype=bfloat16"])
    weights = instantiate_model(cfg, h36m_skeleton_17())[0].state_dict()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 243, 17, 2)).astype(np.float32)
    y = 0.1 * rng.normal(size=(2, 243, 17, 3)).astype(np.float32)
    metrics = {}
    for device in ("cpu", "cuda"):
        model = _bf16_model(cfg, weights, device)
        opt = make_optimizer(model.parameters(), weight_decay=1e-6)
        state = TrainState.create(model, opt, seed=0, device=device)
        ops.reset_launch_counts()
        metrics[device] = {k: v.item() for k, v in
                           make_train_step(model, LossConfig(), h36m_skeleton_17(),
                                           opt)(state, x, y, 4e-5).items()}
        if device == "cuda":
            assert ops.launch_counts(torch.bfloat16) == {**PER_FORWARD, **PER_BACKWARD}
            assert not any(ops.launch_counts(torch.float32).values())
            for name, p in model.named_parameters():
                assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all(), name
    for k, want in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - want) <= BF16_TOL * abs(want), k
    want = _branch_grads(cfg, weights, x, "cpu")
    got = _branch_grads(cfg, weights, x, "cuda")
    for name, w in want.items():
        assert (got[name] - w).norm().item() <= BF16_TOL * w.norm().item(), name


def test_bf16_flagship_forward_on_card_matches_cpu(gen):
    """The flagship model (configs/config.yaml) under model.dtype=bfloat16
    on one window, TTA off, card against CPU from the same weights: both
    branches' outputs (hypotheses before FK, scores, bone lengths) within
    0.05; the decoded poses and hypotheses within 0.05 or 2 * the CPU's
    spread under a one-ulp input nudge + 1e-3; K1, K3 and K5 launched on
    bf16 operands only."""
    cfg = load_config("config", ["model.dtype=bfloat16"])
    card = Predictor(cfg=cfg, batch_size=1, tta=False)
    state = {k: v.cpu() for k, v in card.model.state_dict().items()}
    window = np.random.default_rng(1).normal(size=(243, 17, 2)).astype(np.float32)
    ops.reset_launch_counts()
    got = card.predict_video(window, return_hypotheses=True)
    assert ops.launch_counts(torch.bfloat16) == {
        **{name: 0 for name in PER_BACKWARD},
        "attention_dense": 10, "attention_packed": 10, "fused_mlp": 20,
    }
    assert not any(ops.launch_counts(torch.float32).values())
    cpu = Predictor(cfg=cfg, batch_size=1, tta=False, state_dict=state, device="cpu")
    want = cpu.predict_video(window, return_hypotheses=True)
    nudged = cpu.predict_video(window * BF16_NUDGE, return_hypotheses=True)
    for i, (g, w, n) in enumerate(zip(got, want, nudged)):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        tol = BF16_TOL if i == 2 else max(BF16_TOL, 2 * _rel(n, w) + GAP_SLACK)
        assert _rel(g, w) <= tol, (i, _rel(g, w), _rel(n, w))
    x = torch.from_numpy(window[None])
    with torch.inference_mode():
        branches = [(card.model.rotations_module(x.cuda()), card.model.segments_module(x.cuda())),
                    (cpu.model.rotations_module(x), cpu.model.segments_module(x))]
    (c_hyps, c_scores), c_len = branches[0]
    (w_hyps, w_scores), w_len = branches[1]
    for g, w in ((c_hyps, w_hyps), (c_scores, w_scores), (c_len, w_len)):
        assert _rel(g.float().cpu(), w.float()) <= BF16_TOL


# ---- bf16 P and dS at fp32 accuracy (K1-K4) ---------------------------------

# The bf16 kernels hold P and dS as two bf16 parts (AccMma in
# csrc/attention.cu), so against fp64 from the same bf16 inputs they are
# as accurate as the plain version, which keeps them in fp32: within 5 %
# of its error (+1e-6). Rounded to one bf16 part they were 30-45 % off.
# K2 takes delta = rowsum(dP * P) in fp32, as the plain version and the
# TPU kernel do, so its dq, dk and dv are held within 2 %; with delta
# from the bf16-rounded output its dq sat 4.6 % off at d = 16.
BF16_ACCURACY_RATIO, BF16_ACCURACY_SLACK = 1.05, 1e-6
K2_BF16_ACCURACY_RATIO = 1.02


@pytest.mark.parametrize("kind,b,n,d", [
    ("dense", 34 * 8, 243, 64), ("dense", 32 * 8, 243, 16),
    ("packed", 243 * 8, 17, 64), ("packed", 243 * 8, 16, 16),
])
def test_bf16_attention_kernels_are_as_accurate_as_plain(gen, kind, b, n, d):
    """bf16 K1/K2 (temporal: N 243 at the rotations' d 64 and the segments'
    d 16) and K3/K4 (per window: 17 joints at d 64, 16 bones at d 16),
    one flagship window's worth of rows and more: every output within
    1.05 x the plain version's error against fp64 (+1e-6), K2's dq, dk and
    dv within 1.02 x."""
    qkv = torch.randn((b // 8, n, 3, 8, d), generator=gen, device="cuda").bfloat16()
    dout = torch.randn((b // 8, n, 8, d), generator=gen, device="cuda").bfloat16()
    errs = bf16_attention_errors(kind, qkv, dout.transpose(1, 2), d**-0.5)
    for name, (kernel, plain) in errs.items():
        ratio = (K2_BF16_ACCURACY_RATIO if kind == "dense" and name != "out"
                 else BF16_ACCURACY_RATIO)
        assert kernel <= ratio * plain + BF16_ACCURACY_SLACK, (name, errs)


# ---- evaluation on the card -------------------------------------------------

def test_evaluate_on_card_matches_cpu(gen):
    """``evaluate`` (rMCL, TTA, oracle) of a small model on the card and on
    the CPU from the same weights, over batches whose last one has a padded
    row: predictions, oracle poses and the three MPJPEs within 5e-5 of
    their magnitude; the card runs K1, K3 and K5 and no backward kernel.
    The targets are, frame by frame, one of the model's own hypotheses
    (drawn from the seed) plus 5 mm noise, so that the metrics move with
    the predictions and the oracle pick."""
    from manipose_tpu_torch.data import Batch
    from manipose_tpu_torch.eval.engine import EvalConfig, evaluate

    cfg = load_config("config", OVERRIDES)
    skeleton = h36m_skeleton_17()
    model, _ = instantiate_model(cfg, skeleton)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2, 243, 17, 2)).astype(np.float32)
    with torch.inference_mode():
        hyps = model.eval()(torch.from_numpy(x.reshape(4, 243, 17, 2)))[0].numpy()
    pick = rng.integers(0, hyps.shape[1], size=(4, 243))
    y = np.take_along_axis(hyps, pick[:, None, :, None, None], axis=1)[:, 0]
    y = (y + rng.normal(scale=0.005, size=y.shape)).astype(np.float32).reshape(2, 2, 243, 17, 3)
    batches = [Batch(x[i], y[i], np.asarray([1.0, float(i == 0)], np.float32))
               for i in range(2)]
    results = {}
    for device in ("cpu", "cuda"):
        ops.reset_launch_counts()
        results[device] = evaluate(model.to(device), batches, skeleton, EvalConfig())
    assert ops.launch_counts() == {
        **{name: 0 for name in PER_BACKWARD},
        **{name: 2 * n * len(batches) for name, n in PER_FORWARD.items()},
    }
    got, want = results["cuda"], results["cpu"]
    for g_list, w_list in ((got[0], want[0]), (got[5], want[5])):
        assert [a.shape for a in g_list] == [a.shape for a in w_list] == [
            (2, 243, 17, 3), (1, 243, 17, 3)]
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-5 * np.abs(w).max())
    for g, w in zip(got[2:5], want[2:5]):
        assert abs(g - w) <= 5e-5 * abs(w), (g, w)


def test_batches_are_pinned_off_the_launching_thread(gen):
    """``Batch.pin_memory`` in the prefetch thread gives page-locked
    copies, and ``to_device`` takes them to the card as they are."""
    from manipose_tpu_torch.data import Batch, prefetch

    rng = np.random.default_rng(0)
    batches = [Batch(rng.normal(size=(3, 9, 17, 2)).astype(np.float32),
                     rng.normal(size=(3, 9, 17, 3)).astype(np.float32),
                     np.asarray([1.0, 1.0, 0.0], np.float32)) for _ in range(3)]
    for b, pinned in zip(batches, prefetch(b.pin_memory() for b in batches)):
        assert b.pinned is None and all(t.is_pinned() for t in pinned.pinned)
        for got, want in zip(pinned.to_device(torch.device("cuda")),
                             (b.pose_2d, b.pose_3d, b.valid)):
            assert got.is_cuda
            np.testing.assert_array_equal(got.cpu().numpy(), want)


# ---- the training loop on the card ------------------------------------------

ADAM_STEP = 0.1 / 0.001**0.5  # the most one Adam step moves a parameter, in lr


def _h36m_npz(data_dir, frames=54):
    """Seeded H36M-format npz files: S1 (train), S9 and S11 (validation),
    two actions, four cameras, ``frames`` frames."""
    rng = np.random.default_rng(0)
    subjects, actions = ["S1", "S9", "S11"], ["Walking", "Eating"]
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        s: {a: rng.normal(scale=0.3, size=(frames, 32, 3)).astype(np.float32)
            for a in actions} for s in subjects})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        s: {a: [rng.uniform(0, 1000, size=(frames, 17, 2)).astype(np.float32)
                for _ in range(4)] for a in actions} for s in subjects})


def _driver_cfg(data_dir, out_dir, *extra):
    return load_config("config", OVERRIDES + [
        f"data.data_dir={data_dir}", f"run.output_dir={out_dir}", "data.seq_len=27",
        "data.data=one", "data.actions=walking,eating", "train=debug",
        "train.batch_size=4", "train.batch_size_test=4", "run.test=false", *extra])


def _run(cfg):
    """``drivers.h36m.main``; (train losses, validation losses, end weights)."""
    from manipose_tpu_torch.drivers.h36m import main
    from manipose_tpu_torch.weights import load_torch_checkpoint

    main(cfg)
    out = Path(cfg.run.output_dir) / cfg.run.experiment
    return (np.load(out / "train_loss.npy"), np.load(out / "valid_loss.npy"),
            load_torch_checkpoint(out / "end" / "model.pth"))


def test_train_driver_on_card_matches_cpu(gen, tmp_path):
    """One epoch of the training driver (fp32, drop-path off, 4 steps of 4
    windows) on the card and on the CPU from the same seeded weights: the
    train and validation losses within 1e-4 relative, every parameter
    within 2 * steps * lr * (1 - b1) / sqrt(1 - b2), twice the most Adam
    can move it over the run."""
    _h36m_npz(tmp_path)
    runs = {device: _run(_driver_cfg(tmp_path, tmp_path / device, "model.drop_path_rate=0.0",
                                     f"device={device}"))
            for device in ("cpu", "cuda")}
    (tr_c, va_c, w_c), (tr_g, va_g, w_g) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(tr_g, tr_c, rtol=1e-4, atol=0)
    np.testing.assert_allclose(va_g, va_c, rtol=1e-4, atol=0)
    cfg = _driver_cfg(tmp_path, tmp_path)
    envelope = 2 * 4 * cfg.train.lr * ADAM_STEP
    assert max((w_g[k] - w_c[k]).abs().max().item() for k in w_c) <= envelope


def test_resume_on_card_continues_the_straight_run(gen, tmp_path):
    """Drop-path on (the card's generator is saved): 2 straight epochs, and 1
    epoch + a resumed 1, on the card. The epoch-2 train loss agrees within
    5e-5 relative and the end weights within one epoch's Adam envelope
    (the kernels are deterministic, so the runs should agree bit for
    bit)."""
    _h36m_npz(tmp_path)
    dp = "model.drop_path_rate=0.1"
    straight = _run(_driver_cfg(tmp_path, tmp_path / "straight", dp, "train.epochs=2"))
    _run(_driver_cfg(tmp_path, tmp_path / "part1", dp, "train.epochs=1"))
    resumed = _run(_driver_cfg(tmp_path, tmp_path / "part2", dp, "train.epochs=2",
                               f"run.checkpoint_params={tmp_path / 'part1' / 'default'}"))
    assert len(straight[0]) == 2 and len(resumed[0]) == 1
    np.testing.assert_allclose(resumed[0][0], straight[0][1], rtol=5e-5, atol=0)
    envelope = 2 * 4 * _driver_cfg(tmp_path, tmp_path).train.lr * ADAM_STEP
    gap = max((resumed[2][k] - straight[2][k]).abs().max().item() for k in straight[2])
    assert gap <= envelope, gap


# ---- the MPI-INF-3DHP path and streaming on the card -------------------------

# the 3DHP test's shapes at the flagship's widths (L = 27, batch 25): the
# temporal layers' windows (rotations 25 * 17 windows of 27 frames at head
# dim 64, segments 25 * 16 at 16) and the MLPs' rows (25 * 27 * 17 and
# 25 * 27 * 16)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,d", [(25 * 17, 64), (25 * 16, 16)])
def test_packed_kernels_at_the_3dhp_shapes(gen, b, d, dtype):
    q, k, v = _qkv(gen, b, 8, 27, d, dtype, strided=True)
    dout = torch.randn((b, 27, 8, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    _packed_check(q, k, v, dout, d**-0.5, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,hidden", [(25 * 27 * 17, 512, 1024), (25 * 27 * 16, 128, 256)])
def test_mlp_kernels_at_the_3dhp_shapes(gen, m, c, hidden, dtype):
    x, w1, b1, w2, b2 = _mlp_operands(gen, m, c, hidden, dtype)
    assert _max_err(fused_mlp(x, w1, b1, w2, b2), mlp_plain(x, w1, b1, w2, b2)) \
        <= TOL[dtype][1]
    g = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"),
                          fused_mlp_bwd(x, w1, b1, w2, g), mlp_plain_bwd(x, w1, b1, w2, g)):
        assert _max_err(a, r) <= _grad_tol(r, dtype, relative=True), name


DHP3_OVERRIDES = ["data=mpi_inf_3dhp", "model=small", "model.layers=2",
                  "model.layers_seg=1", "multi_hyp.n_hyp=2", "train.batch_size_test=4"]


def test_3dhp_protocol_on_card_matches_cpu(gen, tmp_path):
    """The 3DHP test protocol (``drivers.dhp3.run_test_protocol``) of a
    small model at L = 27 on FK-synthetic archives, on the card and on the
    CPU from the same weights: the MPJPE family, MPSSE and MPSCE within
    1e-4 relative, PCK and AUC within one joint-frame's share; the card
    runs K3 and K5 (every attention layer per window at N = 27) and
    neither K1 nor a backward kernel."""
    from manipose_tpu_torch.data.dhp3 import Dataset3DHP
    from manipose_tpu_torch.drivers.dhp3 import create_loader, run_test_protocol
    from manipose_tpu_torch.tools.make_synthetic_3dhp import generate

    generate(tmp_path / "data", train_seqs=1, cams=1, frames=30, test_frames=60, seed=0)
    cfg = load_config("config", DHP3_OVERRIDES)
    dataset = Dataset3DHP(tmp_path / "data", train=False)
    model, rmcl = instantiate_model(cfg, dataset.skeleton)
    metrics = {}
    for device in ("cpu", "cuda"):
        ops.reset_launch_counts()
        metrics[device] = run_test_protocol(model.to(device), cfg, dataset, rmcl,
                                            tmp_path / device)
    n_batches = len(create_loader(dataset, cfg, train=False))
    assert ops.launch_counts() == {
        **{name: 0 for name in PER_BACKWARD}, "attention_dense": 0,
        "attention_packed": 2 * 6 * n_batches, "fused_mlp": 2 * 6 * n_batches}
    frames = len(create_loader(dataset, cfg, train=False).dataset) * 27
    for k, w in metrics["cpu"].items():
        g = metrics["cuda"][k]
        tol = 100.0 / (frames * 17) if "pck" in k or "auc" in k else 1e-4 * abs(w)
        assert abs(g - w) <= tol, (k, g, w)


def test_stream_on_card_matches_predict_video(gen):
    """A session of stride L, lookahead 0 on the card equals the card's
    ``predict_video`` (batch 1: the same one-window forward), and a
    stride-1 session on the card matches the CPU's within 5e-5 of the
    magnitude."""
    cfg = load_config("config", DHP3_OVERRIDES)
    card = Predictor(cfg=cfg, batch_size=1, tta=True)
    state = {k: v.cpu() for k, v in card.model.state_dict().items()}
    cpu = Predictor(cfg=cfg, batch_size=1, tta=True, state_dict=state, device="cpu")
    video = np.random.default_rng(0).normal(size=(70, 17, 2)).astype(np.float32)

    def stream(pred, stride, lookahead):
        sess = pred.stream(stride=stride, lookahead=lookahead)
        return np.concatenate([sess.push(video), sess.flush()], axis=0)

    want = card.predict_video(video)
    np.testing.assert_allclose(stream(card, 27, 0), want, rtol=0,
                               atol=5e-5 * max(1.0, float(np.abs(want).max())))
    want = stream(cpu, 1, None)
    np.testing.assert_allclose(stream(card, 1, None), want, rtol=0,
                               atol=5e-5 * max(1.0, float(np.abs(want).max())))


# ---- the rest of serving: int8, export, data-parallel ----------------------

def test_int8_predictor_on_card_matches_cpu(gen):
    """``quantize="force"`` on the card (``torch._int_mm``, K1 and K3, no
    K5) against the CPU from the same float weights. Every ``QuantLinear``
    of a card forward, given its input on the CPU, gives the card's output
    bit for bit (the codes, the int32 product and the dequantization are
    exact on both). End to end the fp32 sums around the int8 layers run in
    another order on each side, so an activation on a rounding boundary of
    its int8 code lands on either code and moves the poses by a
    quantization step: the poses are held in relative norm within 2 x the
    CPU's own change under one-ulp input nudges (up and down) + 5e-5."""
    from manipose_tpu_torch.ops.quant import QuantLinear

    cfg = load_config("config", OVERRIDES)
    state = Predictor(cfg=cfg, device="cpu").model.state_dict()
    card = Predictor(cfg=cfg, batch_size=2, tta=True, quantize="force", state_dict=state)
    cpu = Predictor(cfg=cfg, batch_size=2, tta=True, quantize="force", state_dict=state,
                    device="cpu")
    video = np.random.default_rng(0).normal(size=(300, 17, 2)).astype(np.float32)
    layers = {name: m for name, m in card.model.named_modules() if isinstance(m, QuantLinear)}
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, args, out, name=name: seen.append((name, args[0].cpu(), out.cpu())))
        for name, m in layers.items()]
    ops.reset_launch_counts()
    got = card.predict_video(video)
    for h in hooks:
        h.remove()
    n_batches = 1  # 2 windows of 243 frames
    assert ops.launch_counts() == {
        **{name: 0 for name in PER_BACKWARD}, "fused_mlp": 0,
        "attention_dense": 2 * 3 * n_batches, "attention_packed": 2 * 3 * n_batches}
    cpu_layers = dict(cpu.model.named_modules())
    assert len(seen) == 2 * len(layers)  # TTA: each layer twice
    for name, x, out in seen:
        assert torch.equal(cpu_layers[name](x), out), name

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    want = cpu.predict_video(video)
    spread = max(rel(cpu.predict_video(np.nextafter(video, np.float32(to))), want)
                 for to in (np.inf, -np.inf))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel(got, want) <= 2 * spread + 5e-5, (rel(got, want), spread)


def test_exported_program_on_card_launches_the_kernels(gen):
    """``export_program`` on the card: the loaded program launches K1, K3
    and K5 (the ``manipose::`` operators) and equals the live forward
    within 1e-5 of the magnitude, at 2 windows and at 1."""
    cfg = load_config("config", OVERRIDES)
    pred = Predictor(cfg=cfg, batch_size=2, tta=True)
    program = Predictor.load_program(pred.export_program())
    for b in (2, 1):
        x = torch.randn((b, 243, 17, 2), generator=gen, device="cuda")
        with torch.no_grad():
            want = pred.serving_forward(x)
        ops.reset_launch_counts()
        got = program(x)
        assert ops.launch_counts() == {
            **{name: 0 for name in PER_BACKWARD},
            **{name: 2 * n for name, n in PER_FORWARD.items()}}
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-5 * max(1.0, float(w.abs().max())))


def test_data_parallel_on_one_card_equals_plain(gen):
    """One card: the data-parallel predictor runs the batch as one shard
    on a stream of its own, bit for bit the plain predictor's result."""
    cfg = load_config("config", OVERRIDES)
    plain = Predictor(cfg=cfg, batch_size=2, tta=True)
    state = {k: v.cpu() for k, v in plain.model.state_dict().items()}
    dp = Predictor(cfg=cfg, batch_size=2, tta=True, state_dict=state, data_parallel=True)
    video = np.random.default_rng(1).normal(size=(600, 17, 2)).astype(np.float32)
    for g, w in zip(dp.predict_video(video, return_hypotheses=True),
                    plain.predict_video(video, return_hypotheses=True)):
        np.testing.assert_array_equal(g, w)


# ---- trunk variants: joint-major K3/K4, the megastep as a graph, remat ------

def _jm_qkv(gen, b, j, l, h, d, dtype):
    """The joint-major qkv projection (b, j, l, 3*h*d) and its q, k, v as
    (b, l, h, j, d) views: rows (joints) a frame's qkv row apart."""
    qkv = torch.randn((b, j, l, 3 * h * d), generator=gen, device="cuda").to(dtype)
    return qkv, split_heads(qkv, h)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,j,l,h,d", [(2, 17, 27, 8, 64), (3, 16, 9, 8, 16),
                                       (1, 5, 33, 2, 8), (2, 32, 4, 3, 32)])
def test_joint_major_packed_kernels_match_plain(gen, b, j, l, h, d, dtype):
    """K3/K4 on the strided joint-major views against their plain versions:
    K3 writes the (B, J, L, h, d) output in place, K4 the (B, J, L, 3, h, d)
    gradient of the qkv tensor; no copy of q, k or v is made."""
    qkv, (q, k, v) = _jm_qkv(gen, b, j, l, h, d, dtype)
    assert q.stride() == (j * l * 3 * h * d, 3 * h * d, d, l * 3 * h * d, 1)
    scale = d**-0.5
    out = attention_packed(q, k, v, scale)
    assert out.shape == (b, l, h, j, d) and out.permute(0, 3, 1, 2, 4).is_contiguous()
    assert _max_err(out, attention_plain(q, k, v, scale)) <= TOL[dtype][0]
    dout = torch.randn((b, j, l, h, d), generator=gen,
                       device="cuda").to(dtype).permute(0, 2, 3, 1, 4)
    got = attention_packed_bwd(q, k, v, dout, scale)
    assert got.shape == (b, j, l, 3, h, d) and got.is_contiguous()
    want = torch.stack([g.permute(0, 3, 1, 2, 4) for g in
                        attention_plain_bwd(q, k, v, dout, scale)], dim=3)
    assert _max_err(got, want) <= _grad_tol(want, dtype, relative=False)
    # the differentiable entry on the qkv tensor, against autograd of plain
    x = qkv.detach().float().clone().requires_grad_(True)
    ref = merge_heads(attention_plain(*split_heads(x, h), scale))
    g = torch.randn(ref.shape, generator=gen, device="cuda")
    (ref * g).sum().backward()
    y = qkv.detach().clone().requires_grad_(True)
    ops.reset_launch_counts()
    out2 = attention(y, h, scale)
    (out2.float() * g).sum().backward()
    assert ops.launch_counts()["attention_packed"] == 1
    assert ops.launch_counts()["attention_packed_bwd"] == 1
    assert _max_err(out2, ref) <= TOL[dtype][0]
    assert _max_err(y.grad, x.grad) <= _grad_tol(x.grad, dtype, relative=False)


def test_joint_major_model_on_card_matches_fold(gen):
    """A small rMCL model in the joint-major layout on the card against the
    fold layout on the same weights: the eval forward, then a train step
    with drop-path on from one generator seed (the same masks), gradients
    within the JAX package's fp32 limits; K3/K4 on every spatial layer."""
    skeleton = h36m_skeleton_17()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 243, 17, 2)).astype(np.float32)).cuda()
    y = torch.from_numpy(0.1 * rng.normal(size=(2, 243, 17, 3)).astype(np.float32)).cuda()
    runs = {}
    for layout in ("fold", "joint_major"):
        cfg = load_config("config", OVERRIDES + [f"model.layout={layout}"])
        model, _ = instantiate_model(cfg, skeleton)
        opt = make_optimizer(model.parameters(), weight_decay=1e-6)
        state = TrainState.create(model, opt, seed=3, device="cuda")
        model.eval()
        with torch.no_grad():
            fwd = model(x)
        ops.reset_launch_counts()
        metrics = make_train_step(model, LossConfig(), skeleton, opt)(state, x, y, 4e-5)
        assert ops.launch_counts() == {**PER_FORWARD, **PER_BACKWARD}
        runs[layout] = (fwd, metrics, {n: p.detach().clone() for n, p in
                                       model.named_parameters()})
    (f_fwd, f_m, f_w), (j_fwd, j_m, j_w) = runs["fold"], runs["joint_major"]
    for a, b in zip(j_fwd, f_fwd):
        assert _max_err(a, b) <= 5e-5 * max(1.0, b.abs().max().item())
    for k, v in f_m.items():
        assert abs(j_m[k].item() - v.item()) <= 5e-5 * max(1.0, abs(v.item())), k
    b1, b2 = 0.9, 0.999
    envelope = 2 * 4e-5 * (1 - b1) / (1 - b2) ** 0.5
    for n, w in f_w.items():
        assert _max_err(j_w[n], w) <= envelope, n


def _small_trainer(cfg, weights=None):
    skeleton = h36m_skeleton_17()
    model, _ = instantiate_model(cfg, skeleton)
    if weights is not None:
        model.load_state_dict(weights)
    opt = make_optimizer(model.parameters(), weight_decay=1e-6)
    state = TrainState.create(model, opt, seed=5, device="cuda")
    return skeleton, model, opt, state


@pytest.mark.parametrize("remat", [False, True])
def test_megastep_graph_matches_single_steps(gen, remat):
    """The megastep on the card is one CUDA graph of K steps, captured once
    and replayed: its weights after one call against K single steps from the
    same state (drop-path on) within 2 K lr (1 - b1) / sqrt(1 - b2), its
    losses within 1e-4 relative, the generator left where K steps leave it,
    new masks at every replay, and its launches its capture's times its
    replays."""
    from manipose_tpu_torch.train import make_multi_train_step

    k_steps, lr = 3, 4e-5
    cfg = load_config("config", OVERRIDES + ["model.drop_path_rate=0.3",
                                             f"model.remat={str(remat).lower()}"])
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.normal(size=(k_steps, 2, 243, 17, 2)).astype(np.float32))
    ys = torch.from_numpy(0.1 * rng.normal(size=(k_steps, 2, 243, 17, 3)).astype(np.float32))
    skeleton, model, opt, state = _small_trainer(cfg)
    init = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
    single = make_train_step(model, LossConfig(), skeleton, opt)
    want = [single(state, xs[i], ys[i], lr) for i in range(k_steps)]
    want_w = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_gen = state.generator.get_state()

    _, model2, opt2, state2 = _small_trainer(cfg, init)
    multi = make_multi_train_step(model2, LossConfig(), skeleton, opt2, k_steps)
    ops.reset_launch_counts()
    got = multi(state2, xs, ys, lr)
    assert multi.captures == 1 and multi.replays == 1 and state2.step == k_steps
    # the wrappers counted one eager warm-up step, then the K captured steps
    (graph,) = multi.graphs.values()
    captured = {n: sum(by_dtype.values()) for n, by_dtype in graph.launches.items()}
    per_step = {**{n: c * (2 if remat else 1) for n, c in PER_FORWARD.items()},
                **PER_BACKWARD}
    assert captured == {n: k_steps * c for n, c in per_step.items()}
    assert ops.launch_counts() == {n: (k_steps + 1) * c for n, c in per_step.items()}
    assert ops.replayed_counts() == captured and ops.GRAPH_REPLAYS["replays"] == 1
    assert torch.equal(state2.generator.get_state(), want_gen)
    for key, v in got.items():
        assert v.shape == (k_steps,)
        for i in range(k_steps):
            ref = want[i][key].item()
            assert abs(v[i].item() - ref) <= 1e-4 * max(1.0, abs(ref)), (key, i)
    envelope = 2 * k_steps * lr * (1 - 0.9) / (1 - 0.999) ** 0.5
    for n, p in model2.named_parameters():
        assert _max_err(p, want_w[n]) <= envelope, n
    # a second replay: new masks, so new losses on the same batches
    again = multi(state2, xs, ys, lr)
    assert multi.captures == 1 and multi.replays == 2
    assert ops.GRAPH_REPLAYS["replays"] == 2
    assert ops.replayed_counts() == {n: 2 * c for n, c in captured.items()}
    assert not torch.equal(again["loss"], got["loss"])
    # a new batch shape captures anew
    multi(state2, xs[:, :1], ys[:, :1], lr)
    assert multi.captures == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_on_card_matches_plain(gen, dtype):
    """A remat train step (model.remat=true) on the card against the plain
    step from the same weights and generator state (drop-path on): the loss
    and every gradient within the gradient limit (fp32 5e-4, bf16 0.05, of
    max(1, |g|max)), and the generator left in the same state."""
    from manipose_tpu_torch.train.losses import compute_loss

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 243, 17, 2)).astype(np.float32)).cuda()
    y = torch.from_numpy(0.1 * rng.normal(size=(2, 243, 17, 3)).astype(np.float32)).cuda()
    results, weights = [], None
    for remat in ("false", "true"):
        cfg = load_config("config", OVERRIDES + ["model.drop_path_rate=0.3",
                                                 f"model.dtype={dtype}",
                                                 f"model.remat={remat}"])
        skeleton, model, opt, state = _small_trainer(cfg, weights)
        weights = {n: v.detach().cpu().clone() for n, v in model.state_dict().items()}
        model.train()
        opt.zero_grad()
        total, _ = compute_loss(model(x), y, LossConfig(), skeleton)
        total.backward()
        results.append((total.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()},
                        state.generator.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    tol = 5e-4 if dtype == "float32" else 0.05
    assert torch.equal(s0, s1)
    assert abs(l1 - l0) <= 5e-5 * max(1.0, abs(l0))
    for n, g in g0.items():
        assert _max_err(g1[n], g) <= tol * max(1.0, g.abs().max().item()), n
