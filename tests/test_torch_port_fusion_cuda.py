"""The DSTformer's stream fusion kernels (``ops/csrc/fusion.cu``) on the
card: forward and backward against their plain versions at row counts
around the kernels' 8-row blocks and their grids' walks, at every
channel width they take (a multiple of 4 up to 512), the backward run
twice for bit-for-bit equality, what the wrappers refuse, the autograd
Function against autograd through the plain concatenation, Linear and
softmax, and a small DSTformer's forward and train step on the card
against the CPU with every kernel's launches counted.
Marked ``cuda``; without a CUDA device every test skips. Run on the card
with ``python -m pytest tests/test_torch_port_fusion_cuda.py -q
--noconftest``.

Tolerances: fp32 on both sides, sums in another order. The forward and
the streams' gradients 1e-5 of the reference's largest magnitude (a row's
two dot products of 2C terms); dW and db, sums over every row, 1e-5 times
sqrt(R / 1024) of it, at least 1e-5. The model on the card against the CPU:
K1-K6 carry fp32 as 3xTF32 (5e-5 the forward, 5e-4 the gradients, as
tests/test_torch_port_cuda.py holds the MixSTE model)."""

import numpy as np
import pytest
import torch

from manipose_tpu_torch import ops
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.ops import cuda_fusion
from manipose_tpu_torch.train import LossConfig, TrainState, make_train_step
from manipose_tpu_torch.train.optim import optimizer_from_config

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A seeded generator on the card; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(gen, r, c):
    xs = torch.randn((r, c), generator=gen, device="cuda")
    xt = torch.randn((r, c), generator=gen, device="cuda")
    w = torch.randn((2, 2 * c), generator=gen, device="cuda") / (2 * c) ** 0.5
    b = torch.randn((2,), generator=gen, device="cuda")
    return xs, xt, w, b


def _gap(got, want):
    torch.cuda.synchronize()
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


# rows around a block's 8 and both grids' walks (the forward's 1056 blocks
# of 8 rows, the backward's 264), the benchmark's 132,192; channels at and
# between the 128-wide chunks a lane covers
SHAPES = [(r, c) for r in (1, 7, 9, 2113, 8449, 132192) for c in (512, 132)] + [
    (33, 4), (257, 256), (100, 500)]


@pytest.mark.parametrize("r,c", SHAPES)
def test_fusion_kernels_match_plain(gen, r, c):
    xs, xt, w, b = _operands(gen, r, c)
    g = torch.randn((r, c), generator=gen, device="cuda")
    ops.reset_launch_counts()
    out, alpha = cuda_fusion.fusion_forward(xs, xt, w, b)
    want_out, want_alpha = cuda_fusion.fusion_plain(xs, xt, w, b)
    assert _gap(out, want_out) <= 1e-5 and _gap(alpha, want_alpha) <= 1e-5
    got = cuda_fusion.fusion_backward(g, xs, xt, alpha, w)
    want = cuda_fusion.fusion_plain_bwd(g, xs, xt, want_alpha, w)
    sums = 1e-5 * max(1.0, (r / 1024) ** 0.5)
    for x, y, tol in zip(got, want, (1e-5, 1e-5, sums, sums)):
        assert x.shape == y.shape and _gap(x, y) <= tol
    assert ops.launch_counts(torch.float32, cuda_fusion.PATH) == {
        **dict.fromkeys(ops.launch_counts(), 0), "stream_fusion": 1, "stream_fusion_bwd": 1}


def test_fusion_backward_is_deterministic(gen):
    xs, xt, w, b = _operands(gen, 132192, 512)
    g = torch.randn_like(xs)
    _, alpha = cuda_fusion.fusion_forward(xs, xt, w, b)
    first = cuda_fusion.fusion_backward(g, xs, xt, alpha, w)
    again = cuda_fusion.fusion_backward(g, xs, xt, alpha, w)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fusion_wrappers_refuse(gen):
    xs, xt, w, b = _operands(gen, 16, 512)
    with pytest.raises(TypeError):
        cuda_fusion.fusion_forward(xs.bfloat16(), xt.bfloat16(), w.bfloat16(), b.bfloat16())
    wide = _operands(gen, 16, 516)
    with pytest.raises(ValueError):
        cuda_fusion.fusion_forward(*wide)
    with pytest.raises(ValueError):
        cuda_fusion.fusion_forward(xs.t().contiguous().t(), xt, w, b)
    with pytest.raises(ValueError):
        cuda_fusion.fusion_forward(xs, xt[:, :256].contiguous(), w, b)


def test_stream_fusion_autograd_matches_plain(gen):
    xs, xt, w, b = _operands(gen, 3000, 512)
    g = torch.randn_like(xs)
    card = [t.clone().requires_grad_(True) for t in (xs, xt, w, b)]
    got = torch.autograd.grad(cuda_fusion.stream_fusion(*card), card, g)
    ref = [t.clone().requires_grad_(True) for t in (xs, xt, w, b)]
    alpha = torch.softmax(torch.nn.functional.linear(torch.cat(ref[:2], -1), ref[2], ref[3]), -1)
    want = torch.autograd.grad(alpha[:, :1] * ref[0] + alpha[:, 1:] * ref[1], ref, g)
    for x, y, tol in zip(got, want, (1e-5, 1e-5, 2e-5, 2e-5)):
        assert _gap(x, y) <= tol


OVERRIDES = ["model=dstformer", "train=motionbert_ft", "model.channels=64", "model.nheads=2",
             "model.layers=2", "model.dim_rep=32"]


def test_dstformer_train_step_on_card_matches_cpu(gen):
    """One AdamW step of a small DSTformer at 243 frames (K1/K2 temporal,
    K3/K4 spatial, K5/K6, the fusion kernels) on the card and on the CPU
    from the same weights: the losses and every gradient."""
    cfg = load_config("config", OVERRIDES)
    skeleton = h36m_skeleton_17()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 243, 17, 2)).astype(np.float32)
    y = 0.3 * rng.normal(size=(2, 243, 17, 3)).astype(np.float32)
    weights = None
    metrics, grads = {}, {}
    for device in ("cpu", "cuda"):
        model, _ = instantiate_model(cfg, skeleton)
        if weights is None:
            with torch.no_grad():  # fusions away from 1/2
                for fuse in model.ts_attn:
                    fuse.weight.normal_(0.0, 0.5 / 128**0.5)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        opt = optimizer_from_config(model, cfg)
        state = TrainState.create(model, opt, device=device)
        step = make_train_step(model, LossConfig(w_loss=False, vel_loss=20.0, smooth_reg=0.0,
                                                 rmcl=False, nmpjpe=0.5), skeleton, opt)
        ops.reset_launch_counts()
        metrics[device] = {k: v.item() for k, v in step(state, x, y, 5e-4).items()}
        if device == "cuda":
            per_stream = {"attention_dense": 2, "attention_packed": 2, "fused_mlp": 4}
            want = {k: 2 * n for k, n in per_stream.items()}
            want.update({k + "_bwd": n for k, n in want.items()})
            want.update(stream_fusion=2, stream_fusion_bwd=2)
            # 19 Dense calls, all on the library at 64 channels (ops.cuda_linear):
            # the embedding, 2 depths x 2 streams x 2 attention layers' qkv and
            # proj, pre_logits and the head
            want.update(linear=19, linear_bwd=0)
            assert ops.launch_counts() == ops.launch_counts(torch.float32) == want
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    for k, want in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - want) <= 5e-5 * max(1.0, abs(want)), k
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert torch.isfinite(got).all(), name
        assert (got - want).abs().max().item() <= 5e-4 * max(1.0, want.abs().max().item()), name
