"""PyTorch port vs the JAX package: the plain backward versions of the
port's kernels K2, K4 and K6 against ``jax.grad`` through the Pallas
kernels (interpret mode on the CPU), and the autograd Functions' CPU path
against autograd through the plain forward. The backward kernels
themselves are checked on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.

Tolerances are the JAX package's own gradient ones
(tests/test_pallas_attention.py, tests/test_pallas_mlp.py): 5e-4 for
attention, 5e-4 * max(1, |ref|max) for the MLP in fp32 and 0.05 times
that scale in bf16."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manipose_tpu.ops.pallas_attention import (
    flash_attention,
    flash_attention_packed,
)
from manipose_tpu.ops.pallas_mlp import fused_mlp as j_fused_mlp
from manipose_tpu.ops.pallas_mlp import supported
from manipose_tpu_torch import ops
from manipose_tpu_torch.ops.cuda_attention import (
    attention,
    attention_dense_bwd,
    attention_packed_bwd,
    attention_plain,
    attention_plain_bwd,
)
from manipose_tpu_torch.ops.cuda_mlp import (
    fused_mlp,
    mlp_plain,
    mlp_plain_bwd,
    round_to_tf32,
)

ATTN_GRAD_TOL = 5e-4
MLP_GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 0.05}

# the shapes of tests/test_pallas_attention.py: (batch, heads, N, d)
DENSE_LAYOUTS = [(6, 4, 17, 64), (2, 4, 243, 64), (3, 2, 128, 32)]
PACKED_LAYOUTS = [(6, 4, 17, 64), (8, 2, 17, 32), (5, 1, 17, 64)]


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("kind,b,h,n,d",
                         [("dense", *s) for s in DENSE_LAYOUTS]
                         + [("packed", *s) for s in PACKED_LAYOUTS])
def test_attention_plain_bwd_matches_pallas_grad(kind, b, h, n, d):
    rng = np.random.default_rng(10)
    q, k, v, do = (_normal(rng, (b, h, n, d)) for _ in range(4))
    scale = d**-0.5
    fn = flash_attention if kind == "dense" else flash_attention_packed
    want = jax.grad(lambda *a: jnp.sum(fn(*a, scale) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    got = attention_plain_bwd(*map(torch.from_numpy, (q, k, v, do)), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_GRAD_TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("kind,n", [("dense", 243), ("dense", 40),
                                    ("packed", 17), ("packed", 16)])
def test_attention_wrappers_on_cpu_give_the_qkv_gradient(kind, n):
    """The backward wrappers' CPU path: the plain gradients, laid out as
    the (B, N, 3, h, d) gradient of the qkv tensor."""
    b, h, d = 2, 4, 16
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(_normal(rng, (b, h, n, d))) for _ in range(4))
    if kind == "dense":
        got = attention_dense_bwd(q, k, v, None, do, None, 0.25)
    else:
        got = attention_packed_bwd(q, k, v, do, 0.25)
    assert got.shape == (b, n, 3, h, d)
    for i, want in enumerate(attention_plain_bwd(q, k, v, do, 0.25)):
        assert torch.equal(got[:, :, i].transpose(1, 2), want)


LOG2E = math.log2(math.e)


def _tf32_product(a, b, passes):
    """a @ b with both operands split as the fp32 kernels split them, three
    tf32 passes (small*big + big*small + big*big) or one (big*big)."""
    a_big, b_big = round_to_tf32(a), round_to_tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = round_to_tf32(a - a_big), round_to_tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


# a 64-row tile's rows in the order the fp32 k-steps over rows take them
# (k-index t reads row 2t, t + 4 row 2t + 1; attention.cu, acc_to_a and
# load_b_rows)
TILE_ROWS = (torch.arange(0, 64, 8)[:, None]
             + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])).reshape(-1)


def k2_arithmetic(q, k, v, out, do, lse, scale, passes=3):
    """K2's fp32 arithmetic on the CPU, both passes over operands
    zero-padded to whole 64-row tiles. The dQ pass walks 64-key tiles:
    P = exp2(c S - lse) (keys past N at 0), dP = dO V^T, dS = P (dP -
    delta), dQ += dS K. The dK/dV pass walks 64-query tiles on the
    transposed scores: P^T, dP^T = V dO^T, dS^T, dV += P^T dO,
    dK += dS^T Q (queries past N with lse = +inf, so P^T is 0 there).
    Every product over rows runs from a fresh sum over one tile."""
    n = q.shape[2]
    n_pad = -(-n // 64) * 64

    def pad(t, value=0.0):
        return torch.nn.functional.pad(t, (0, 0, 0, n_pad - n), value=value)

    qp, kp, vp, dop = map(pad, (q, k, v, do))
    c = scale * LOG2E
    lse2 = pad(lse[..., None] * LOG2E, math.inf)  # (b, h, n_pad, 1)
    delta = pad((do * out).sum(-1, keepdim=True))
    valid = torch.arange(n_pad) < n
    dq, dk, dv = (torch.zeros_like(qp) for _ in range(3))
    for r0 in range(0, n_pad, 64):
        rows = slice(r0, r0 + 64)
        kt, vt, qt, dot = kp[:, :, rows], vp[:, :, rows], qp[:, :, rows], dop[:, :, rows]
        # dQ pass, this key tile
        p = torch.exp2(_tf32_product(qp, kt.transpose(-1, -2), passes) * c - lse2)
        p = p.masked_fill(~valid[rows], 0.0)
        ds = p * (_tf32_product(dop, vt.transpose(-1, -2), passes) - delta)
        dq += _tf32_product(ds[..., TILE_ROWS], kt[:, :, TILE_ROWS], passes)
        # dK/dV pass, this query tile
        pt = torch.exp2(_tf32_product(kp, qt.transpose(-1, -2), passes) * c
                        - lse2[:, :, rows].transpose(-1, -2))
        dv += _tf32_product(pt[..., TILE_ROWS], dot[:, :, TILE_ROWS], passes)
        dst = pt * (_tf32_product(vp, dot.transpose(-1, -2), passes)
                    - delta[:, :, rows].transpose(-1, -2))
        dk += _tf32_product(dst[..., TILE_ROWS], qt[:, :, TILE_ROWS], passes)
    return dq[:, :, :n] * scale, dk[:, :, :n] * scale, dv[:, :, :n]


def _pallas_grads_and_k2(q, k, v, do, scale, passes):
    """jax.grad through flash_attention, and K2's arithmetic from the
    exact forward's output and log-sum-exp."""
    want = jax.grad(lambda *a: jnp.sum(flash_attention(*a, scale) * do), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    scores = scale * tq @ tk.transpose(-1, -2)
    out = torch.softmax(scores, -1) @ tv
    got = k2_arithmetic(tq, tk, tv, out, tdo, torch.logsumexp(scores, -1), scale, passes)
    return got, want


@pytest.mark.parametrize("b,h,n,d", [(2, 4, 243, 64), (3, 2, 128, 32), (2, 3, 100, 16)])
def test_k2_tensor_core_arithmetic_matches_pallas_grad(b, h, n, d):
    """K2's 3xTF32 passes stay within the JAX package's 5e-4 of the
    custom_vjp gradients of flash_attention."""
    rng = np.random.default_rng(15)
    q, k, v, do = (_normal(rng, (b, h, n, d)) for _ in range(4))
    got, want = _pallas_grads_and_k2(q, k, v, do, d**-0.5, passes=3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_k2_one_tf32_pass_misses_the_gradient_tolerance():
    """With its operands rounded to tf32 once, K2 at the flagship's N = 243,
    d = 64 is off by more than 5e-4."""
    rng = np.random.default_rng(15)
    q, k, v, do = (_normal(rng, (2, 4, 243, 64)) for _ in range(4))
    errs = {}
    for passes in (3, 1):
        got, want = _pallas_grads_and_k2(q, k, v, do, 0.125, passes)
        errs[passes] = max(np.abs(g.numpy() - np.asarray(w)).max()
                           for g, w in zip(got, want))
    assert errs[3] <= ATTN_GRAD_TOL < errs[1]


def _step_order(width):
    """Rows (or columns) of a width in the order the fp32 k-steps take them."""
    return (torch.arange(0, width, 8)[:, None]
            + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])).reshape(-1)


def k4_arithmetic(q, k, v, do, scale, passes=3):
    """K4's fp32 arithmetic on the CPU: queries (and dO) zero-padded to
    whole 16-row tiles, keys (and V) to whole 8-key tiles. S = Q K^T and
    dP = dO V^T from one sum over d, keys past N at -inf, P = exp2(S - max)
    / l, delta = rowsum(dP * P), dS = P (dP - delta); dQ = scale dS K over
    the keys, dV = P^T dO and dK = scale dS^T Q over the queries, each one
    sum in the fp32 k-step order."""
    n = q.shape[2]
    rows, keys = -(-n // 16) * 16, -(-n // 8) * 8

    def pad(t, width):
        return torch.nn.functional.pad(t, (0, 0, 0, width - n))

    qp, dop = pad(q, rows), pad(do, rows)
    kp, vp = pad(k, keys), pad(v, keys)
    s = _tf32_product(qp, kp.transpose(-1, -2), passes) * (scale * LOG2E)
    s = s.masked_fill(torch.arange(keys) >= n, -math.inf)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    dp = _tf32_product(dop, vp.transpose(-1, -2), passes)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    kord, qord = _step_order(keys), _step_order(rows)
    dq = _tf32_product(ds[..., kord], kp[:, :, kord], passes) * scale
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dv = _tf32_product(pt[..., qord], dop[:, :, qord], passes)
    dk = _tf32_product(dst[..., qord], qp[:, :, qord], passes) * scale
    return dq[:, :, :n], dk[:, :, :n], dv[:, :, :n]


def _packed_grads_and_k4(q, k, v, do, scale, passes):
    want = jax.grad(lambda *a: jnp.sum(flash_attention_packed(*a, scale) * do),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = k4_arithmetic(*map(torch.from_numpy, (q, k, v, do)), scale, passes)
    return got, want


@pytest.mark.parametrize("d", [8, 16, 64])
@pytest.mark.parametrize("n", [1, 7, 16, 17, 32])
def test_k4_tensor_core_arithmetic_matches_pallas_grad(n, d):
    """K4's 3xTF32 window, padded to its tiles, stays within the JAX
    package's 5e-4 of the custom_vjp gradients of flash_attention_packed
    at every tile edge."""
    rng = np.random.default_rng(30 + n)
    q, k, v, do = (_normal(rng, (3, 2, n, d)) for _ in range(4))
    got, want = _packed_grads_and_k4(q, k, v, do, d**-0.5, passes=3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_GRAD_TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [64, 16])
def test_k4_one_tf32_pass_misses_the_gradient_tolerance(d):
    """With its operands rounded to tf32 once, K4 on windows of the
    flagship's N = 17 is off by more than 5e-4 at both head dims."""
    rng = np.random.default_rng(31)
    q, k, v, do = (_normal(rng, (64, 8, 17, d)) for _ in range(4))
    errs = {}
    for passes in (3, 1):
        got, want = _packed_grads_and_k4(q, k, v, do, d**-0.5, passes)
        errs[passes] = max(np.abs(g.numpy() - np.asarray(w)).max()
                           for g, w in zip(got, want))
    assert errs[3] <= ATTN_GRAD_TOL < errs[1]


def _merged_plain_attention(qkv, h, scale):
    b, n, c3 = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, c3 // (3 * h)).unbind(2))
    out = attention_plain(q, k, v, scale)
    return out.transpose(1, 2).reshape(b, n, -1)


@pytest.mark.parametrize("n,h,d", [(243, 4, 16), (17, 8, 8), (16, 2, 32)])
def test_attention_function_matches_autograd_of_plain(n, h, d):
    rng = np.random.default_rng(12)
    qkv = torch.from_numpy(_normal(rng, (3, n, 3 * h * d)))
    w = torch.from_numpy(_normal(rng, (3, n, h * d)))
    ops.reset_launch_counts()
    ours = qkv.clone().requires_grad_()
    (attention(ours, h, d**-0.5) * w).sum().backward()
    ref = qkv.clone().requires_grad_()
    (_merged_plain_attention(ref, h, d**-0.5) * w).sum().backward()
    np.testing.assert_allclose(ours.grad.numpy(), ref.grad.numpy(),
                               atol=ATTN_GRAD_TOL, rtol=0)
    assert not any(ops.launch_counts().values())


def _mlp_data(m, c, h, seed):
    """numpy operands in flax layout (w1 (C, H), w2 (H, C)) and a
    cotangent."""
    rng = np.random.default_rng(seed)
    return (_normal(rng, (m, c), 0.5), _normal(rng, (c, h), 0.1),
            _normal(rng, (h,), 0.05), _normal(rng, (h, c), 0.1),
            _normal(rng, (c,), 0.05), _normal(rng, (m, c)))


@pytest.mark.parametrize("m,c,h,dtype", [
    (256, 64, 128, torch.float32), (512, 128, 256, torch.float32),
    (256, 64, 128, torch.bfloat16),
])
def test_mlp_plain_bwd_matches_pallas_grad(m, c, h, dtype):
    assert supported(m)
    x, w1, b1, w2, b2, g = _mlp_data(m, c, h, seed=13)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    cot = jnp.asarray(g, jdt)
    want = jax.grad(lambda *a: jnp.sum((j_fused_mlp(*a) * cot).astype(jnp.float32)),
                    argnums=tuple(range(5)))(*args)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
         for a in (x, w1.T, b1, w2.T, g)]
    dx, dw1, db1, dw2, db2 = mlp_plain_bwd(*t)
    # the port keeps torch's (out, in) weight layout: transpose to flax's
    got = (dx, dw1.t(), db1, dw2.t(), db2)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == dtype, name
        b = np.asarray(b, np.float32)
        atol = MLP_GRAD_TOL[dtype] * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, rtol=0,
                                   err_msg=name)


def test_mlp_function_matches_autograd_of_plain():
    x, w1, b1, w2, b2, g = _mlp_data(40, 64, 128, seed=14)  # M the TPU refuses
    base = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w1.T, b1, w2.T, b2)]
    ours = [a.clone().requires_grad_() for a in base]
    ref = [a.clone().requires_grad_() for a in base]
    (fused_mlp(*ours) * torch.from_numpy(g)).sum().backward()
    (mlp_plain(*ref) * torch.from_numpy(g)).sum().backward()
    for a, b in zip(ours, ref):
        atol = MLP_GRAD_TOL[torch.float32] * max(1.0, b.grad.abs().max().item())
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=atol, rtol=0)
