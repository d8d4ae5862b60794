"""PyTorch port vs the JAX package: the plain versions of the port's
kernels against the Pallas kernels (interpret mode on the CPU), device
dispatch and launch counting. The kernels themselves are checked on the
card by tests/test_torch_port_cuda.py and chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manipose_tpu.ops.attention import multi_head_attention as j_mha
from manipose_tpu.ops.pallas_attention import (
    flash_attention,
    flash_attention_packed,
)
from manipose_tpu.ops.pallas_mlp import fused_mlp as j_fused_mlp
from manipose_tpu.ops.pallas_mlp import supported
from manipose_tpu_torch import ops
from manipose_tpu_torch.ops import build
from manipose_tpu_torch.ops.attention import multi_head_attention
from manipose_tpu_torch.ops.cuda_attention import (
    attention,
    attention_dense,
    attention_packed,
    attention_plain,
    attention_plain_bwd,
    merge_heads,
    padded_head_dim,
    split_heads,
)
from manipose_tpu_torch.ops import cuda_fusion, cuda_linear, cuda_mlp, launches
from manipose_tpu_torch.ops.probes import run_probes
from manipose_tpu_torch.ops.cuda_mlp import (
    fused_mlp,
    fused_mlp_bwd,
    mlp_forward,
    mlp_plain,
    mlp_plain_bwd,
    padded_widths,
    round_to_tf32,
    takes_wgmma,
    wgmma_wgrad_splits,
)

# the shapes of tests/test_pallas_attention.py: (batch, heads, N, d)
DENSE_LAYOUTS = [(6, 4, 17, 64), (2, 4, 243, 64), (3, 2, 128, 32)]
PACKED_LAYOUTS = [(6, 4, 17, 64), (8, 2, 17, 32), (5, 1, 17, 64)]
ATTN_TOL = 2e-5
MLP_TOL = 5e-5


def _qkv(b, h, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3)]


def _mlp_data(m, c, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, c)).astype(np.float32) * 0.5
    w1 = rng.normal(size=(c, h)).astype(np.float32) * 0.1  # flax (in, out)
    b1 = rng.normal(size=(h,)).astype(np.float32) * 0.05
    w2 = rng.normal(size=(h, c)).astype(np.float32) * 0.1
    b2 = rng.normal(size=(c,)).astype(np.float32) * 0.05
    return x, w1, b1, w2, b2


def _torch_mlp_args(x, w1, b1, w2, b2, dtype=torch.float32):
    """numpy flax-layout operands -> torch Linear layout."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in (x, w1.T, b1, w2.T, b2)]


@pytest.mark.parametrize("b,h,n,d", DENSE_LAYOUTS)
def test_dense_attention_matches_pallas(b, h, n, d):
    q, k, v = _qkv(b, h, n, d)
    scale = d**-0.5
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = attention_dense(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("b,h,n,d", PACKED_LAYOUTS)
def test_packed_attention_matches_pallas(b, h, n, d):
    q, k, v = _qkv(b, h, n, d, seed=2)
    scale = d**-0.5
    want = flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale
    )
    got = attention_packed(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


def _qkv_projection(b, h, n, d, seed):
    """A (B, N, 3*h*d) qkv projection and its q, k, v as (B, h, N, d)."""
    qkv = np.random.default_rng(seed).normal(size=(b, n, 3, h, d))
    qkv = qkv.astype(np.float32)
    q, k, v = (np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    return torch.from_numpy(qkv.reshape(b, n, 3 * h * d)), (q, k, v)


@pytest.mark.parametrize("n", [17, 243])
def test_multi_head_attention_matches_jax_pallas_path(n):
    qkv, (q, k, v) = _qkv_projection(2, 4, n, 16, seed=3)
    scale = 16**-0.5
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                 impl="pallas")
    got = multi_head_attention(qkv, 4, scale)
    assert got.shape == (2, n, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


def test_comb_attention_matches_jax():
    qkv, (q, k, v) = _qkv_projection(2, 2, 17, 8, seed=4)
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, comb=True)
    got = multi_head_attention(qkv, 2, 0.3, comb=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


def test_mlp_matches_pallas_fp32():
    m = 256
    assert supported(m)
    data = _mlp_data(m, 64, 128)
    want = j_fused_mlp(*map(jnp.asarray, data))
    got = fused_mlp(*_torch_mlp_args(*data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MLP_TOL, rtol=0)


def test_mlp_matches_pallas_bf16():
    data = _mlp_data(256, 64, 128, seed=1)
    want = j_fused_mlp(*(jnp.asarray(a, jnp.bfloat16) for a in data))
    got = fused_mlp(*_torch_mlp_args(*data, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0)


def test_round_to_tf32_rounds_as_cvt_rna():
    """Keeps 10 mantissa bits, rounds to nearest with ties away from zero
    (round-to-even would take 1 + 2^-11 down to 1), leaves tf32 values,
    infinities and NaN as they are."""
    exact = torch.tensor([0.0, -0.0, 1.0, 1 + 2**-10, -3.5, 2.0**-126, 1e30])
    exact = round_to_tf32(exact)
    assert torch.equal(round_to_tf32(exact), exact)
    ties = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11])
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1 + 2**-9])
    assert torch.equal(round_to_tf32(ties), want)
    assert torch.equal(round_to_tf32(torch.tensor([1 + 2**-12])), torch.tensor([1.0]))
    special = round_to_tf32(torch.tensor([float("inf"), float("-inf"), float("nan")]))
    assert special[0] == float("inf") and special[1] == float("-inf")
    assert torch.isnan(special[2])


def test_3xtf32_forward_holds_the_fp32_tolerance():
    """The fp32 K5 on the card runs 3xTF32: each operand x splits into
    big = tf32(x) and small = tf32(x - big), and small*big + big*small +
    big*big are summed in fp32. Emulated here at the flagship's width
    (C 512, H 1024) with torch-default-init weights, it stays within the
    JAX package's 5e-5 of an fp64 product, where one tf32 pass does not."""
    import torch.nn.functional as F

    rng = np.random.default_rng(7)
    m, c, h = 256, 512, 1024
    x = rng.normal(size=(m, c))
    w1 = rng.uniform(-1, 1, size=(h, c)) / c**0.5
    b1 = rng.uniform(-1, 1, size=h) / c**0.5
    w2 = rng.uniform(-1, 1, size=(c, h)) / h**0.5
    b2 = rng.uniform(-1, 1, size=c) / h**0.5
    ref = F.linear(F.gelu(F.linear(*map(torch.from_numpy, (x, w1, b1)))),
                   *map(torch.from_numpy, (w2, b2)))

    def three_pass(a, w):
        a_big, w_big = round_to_tf32(a), round_to_tf32(w)
        a_small, w_small = round_to_tf32(a - a_big), round_to_tf32(w - w_big)
        return a_small @ w_big.T + a_big @ w_small.T + a_big @ w_big.T

    def one_pass(a, w):
        return round_to_tf32(a) @ round_to_tf32(w).T

    errs = {}
    for mm in (three_pass, one_pass):
        x32, w1_32, b1_32, w2_32, b2_32 = (torch.from_numpy(a).float()
                                           for a in (x, w1, b1, w2, b2))
        out = mm(F.gelu(mm(x32, w1_32) + b1_32), w2_32) + b2_32
        errs[mm.__name__] = (out.double() - ref).abs().max().item()
    assert errs["three_pass"] <= MLP_TOL
    assert errs["one_pass"] > MLP_TOL


LOG2E = math.log2(math.e)
# the fp32 kernels' k-index permutation within an 8-key k-step of P V:
# k-index t reads key 2t, t + 4 reads key 2t + 1 (attention.cu, acc_to_a and
# load_b_rows)
KEY_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _tf32_product(a, b, passes):
    """a @ b with both operands split as the fp32 kernels split them, three
    tf32 passes (small*big + big*small + big*big) or one (big*big)."""
    a_big, b_big = round_to_tf32(a), round_to_tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = round_to_tf32(a - a_big), round_to_tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _tile_keys(width):
    """The keys of a tile in the order the fp32 k-steps take them."""
    return (torch.arange(0, width, 8)[:, None] + KEY_PERM).reshape(-1)


def k1_arithmetic(q, k, v, scale, passes=3):
    """K1's fp32 arithmetic on the CPU: K and V zero-padded to whole 64-key
    tiles; per tile S = Q K^T in log2 units (keys past N at -inf), the
    online softmax, P V from a fresh sum over the tile's keys in the fp32
    k-step order, and o = o * corr + pv. Returns (out, lse)."""
    n = q.shape[2]
    n_pad = -(-n // 64) * 64
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, n_pad - n)) for t in (k, v))
    valid = torch.arange(n_pad) < n
    keys = _tile_keys(64)
    c = scale * LOG2E
    m = torch.full(q.shape[:3] + (1,), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, n_pad, 64):
        kt, vt = kp[:, :, k0:k0 + 64], vp[:, :, k0:k0 + 64]
        s = _tf32_product(q, kt.transpose(-1, -2), passes) * c
        s = s.masked_fill(~valid[k0:k0 + 64], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _tf32_product(p[..., keys], vt[:, :, keys], passes)
        m = m_new
    return o / l, ((m + torch.log2(l)) / LOG2E)[..., 0]


@pytest.mark.parametrize("b,h,n,d", [(2, 4, 243, 64), (3, 2, 128, 32), (2, 3, 100, 16)])
def test_k1_tensor_core_arithmetic_matches_pallas(b, h, n, d):
    """K1's 3xTF32 tiles with the online rescale stay within the JAX
    package's 2e-5 of its flash_attention, and its log-sum-exp within 1e-5
    of the exact one."""
    q, k, v = _qkv(b, h, n, d, seed=8)
    scale = d**-0.5
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got, lse = k1_arithmetic(tq, tk, tv, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)
    exact = torch.logsumexp(scale * tq.double() @ tk.double().transpose(-1, -2), -1)
    np.testing.assert_allclose(lse.numpy(), exact.numpy(), atol=1e-5, rtol=0)


def test_k1_one_tf32_pass_misses_the_fp32_tolerance():
    """The reason for three passes: with its operands rounded to tf32 once,
    K1 at the flagship's N = 243, d = 64 is off by more than 2e-5."""
    q, k, v = _qkv(2, 4, 243, 64, seed=9)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125)
    errs = {}
    for passes in (3, 1):
        got, _ = k1_arithmetic(*map(torch.from_numpy, (q, k, v)), 0.125, passes)
        errs[passes] = np.abs(got.numpy() - np.asarray(want)).max()
    assert errs[3] <= ATTN_TOL < errs[1]


PACKED_NS = [1, 7, 16, 17, 32]
PACKED_DIMS = [8, 16, 64]


def k3_arithmetic(q, k, v, scale, passes=3):
    """K3's fp32 arithmetic on the CPU: the queries zero-padded to whole
    16-row tiles and the keys to whole 8-key tiles; S = Q K^T in log2
    units from one sum over d, keys past N at -inf, P = exp2(S - max), then
    P V from one sum over the keys in the fp32 k-step order, and o / l."""
    n = q.shape[2]
    rows, keys = -(-n // 16) * 16, -(-n // 8) * 8
    qp = torch.nn.functional.pad(q, (0, 0, 0, rows - n))
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, keys - n)) for t in (k, v))
    s = _tf32_product(qp, kp.transpose(-1, -2), passes) * (scale * LOG2E)
    s = s.masked_fill(torch.arange(keys) >= n, -math.inf)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    order = _tile_keys(keys)
    o = _tf32_product(p[..., order], vp[:, :, order], passes) / p.sum(-1, keepdim=True)
    return o[:, :, :n]


@pytest.mark.parametrize("d", PACKED_DIMS)
@pytest.mark.parametrize("n", PACKED_NS)
def test_k3_tensor_core_arithmetic_matches_pallas(n, d):
    """K3's 3xTF32 window, padded to its tiles, stays within the JAX
    package's 2e-5 of flash_attention_packed at every tile edge."""
    q, k, v = _qkv(3, 2, n, d, seed=20 + n)
    scale = d**-0.5
    want = flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    got = k3_arithmetic(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("d", [64, 16])
def test_k3_one_tf32_pass_misses_the_fp32_tolerance(d):
    """The reason for three passes in K3 too: with its operands rounded to
    tf32 once, a window of the flagship's N = 17 is off by more than 2e-5
    at both of the flagship's head dims."""
    q, k, v = _qkv(64, 8, 17, d, seed=21)
    scale = d**-0.5
    want = flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    errs = {}
    for passes in (3, 1):
        got = k3_arithmetic(*map(torch.from_numpy, (q, k, v)), scale, passes)
        errs[passes] = np.abs(got.numpy() - np.asarray(want)).max()
    assert errs[3] <= ATTN_TOL < errs[1]


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors run the plain versions, bit for bit, and launch nothing."""
    from manipose_tpu_torch.models import Attention, Mlp

    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 17, 16, seed=5))
    assert torch.equal(attention_packed(q, k, v, 0.25), attention_plain(q, k, v, 0.25))
    assert torch.equal(attention_dense(q, k, v, 0.25), attention_plain(q, k, v, 0.25))
    args = _torch_mlp_args(*_mlp_data(40, 64, 128))  # M the TPU kernel refuses
    assert torch.equal(fused_mlp(*args), mlp_plain(*args))
    with torch.no_grad():
        Attention(32, 4)(torch.randn(3, 17, 32))
        Mlp(32, 64)(torch.randn(3, 9, 32))
    assert ops.launch_counts() == {
        "attention_dense": 0, "attention_packed": 0, "attention_dense_bwd": 0,
        "attention_packed_bwd": 0, "fused_mlp": 0, "fused_mlp_bwd": 0,
        "stream_fusion": 0, "stream_fusion_bwd": 0, "linear": 0, "linear_bwd": 0,
    }
    assert ops.launch_counts(torch.bfloat16) == ops.launch_counts(torch.float32) \
        == ops.launch_counts()


# ---- K5's two kernels: which one a launch takes, and its count -----------

@pytest.mark.parametrize("dtype,c,h,wgmma", [
    (torch.float32, 512, 1024, True),  # the rotations trunk
    (torch.float32, 512, 128, True),
    (torch.float32, 512, 960, False),  # H not a multiple of 128
    (torch.float32, 128, 256, False),  # the segments trunk
    (torch.float32, 256, 512, False),
    (torch.bfloat16, 512, 1024, False),
])
def test_k5_path_rule(dtype, c, h, wgmma):
    """fp32 at C = 512 with H a multiple of 128 takes the wgmma kernel,
    every other launch the mma.sync kernel."""
    assert takes_wgmma(dtype, c, h) is wgmma


class _FakeLibrary:
    """Stands in for the built libraries: records which entry point a launch
    called and reports success."""

    def __init__(self):
        self.calls = []

    def mp_fused_mlp(self, *args):
        self.calls.append("mma.sync")
        return 0

    def mp_fused_mlp_sm90(self, *args):
        self.calls.append("wgmma")
        return 0

    def mp_fused_mlp_bwd(self, *args):
        self.calls.append("bwd mma.sync")
        return 0

    def mp_fused_mlp_bwd_sm90(self, *args):
        self.calls.append("bwd wgmma")
        return 0

    def mp_stream_fusion(self, *args):
        self.calls.append("fusion")
        return 0

    def mp_stream_fusion_bwd(self, *args):
        self.calls.append("fusion bwd")
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """mlp_forward, fused_mlp_bwd and the fusion's wrappers on CPU tensors
    as if they lay on a card: the launch goes to a fake library."""
    lib = _FakeLibrary()
    for module in (cuda_mlp, cuda_fusion):
        monkeypatch.setattr(module, "_plain_or_raise", lambda x: False)
        monkeypatch.setattr(module, "_check", lambda *args: None)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    ops.reset_launch_counts()
    yield lib
    ops.reset_launch_counts()


def _k5_launch(m, c, h, dtype):
    x = torch.zeros((m, c), dtype=dtype)
    mlp_forward(x, torch.zeros((h, c), dtype=dtype), torch.zeros(h, dtype=dtype),
                torch.zeros((c, h), dtype=dtype), torch.zeros(c, dtype=dtype))


@pytest.mark.parametrize("m", [1, 459, 4097])
def test_k5_counts_its_wgmma_launches(fake_card, m):
    """Each K5 launch counts once in the ledger, under the path the rule
    sent it to, at any row count."""
    _k5_launch(m, 512, 1024, torch.float32)
    _k5_launch(m, 128, 256, torch.float32)
    _k5_launch(m, 512, 1024, torch.bfloat16)
    assert fake_card.calls == ["wgmma", "mma.sync", "mma.sync"]
    assert ops.launch_counts()["fused_mlp"] == 3
    assert ops.launch_counts(path="wgmma")["fused_mlp"] == 1
    assert ops.launch_counts(torch.float32, "wgmma")["fused_mlp"] == 1
    assert ops.launch_counts(torch.bfloat16, "wgmma")["fused_mlp"] == 0
    assert ops.launch_counts(torch.float32, "mma.sync")["fused_mlp"] == 1
    assert ops.launch_counts(torch.bfloat16, "mma.sync")["fused_mlp"] == 1


# ---- K6's two paths: the same rule as K5's, and their count ---------------

def _bwd_launch(m, c, h, dtype):
    x = torch.zeros((m, c), dtype=dtype)
    fused_mlp_bwd(x, torch.zeros((h, c), dtype=dtype), torch.zeros(h, dtype=dtype),
                  torch.zeros((c, h), dtype=dtype), torch.zeros((m, c), dtype=dtype))


@pytest.mark.parametrize("kernel,launch", [("fused_mlp", _k5_launch),
                                           ("fused_mlp_bwd", _bwd_launch)])
def test_wgmma_counter_starts_at_zero_replays_and_resets(fake_card, kernel, launch):
    """K5's (or K6's) wgmma launches start at zero and count by dtype in the
    ledger, apart from the other kernel's; a graph replay adds its
    capture's launches to the replayed count, and the reset clears both."""
    other = {"fused_mlp": "fused_mlp_bwd", "fused_mlp_bwd": "fused_mlp"}[kernel]
    assert ops.launch_counts(path="wgmma")[kernel] == 0
    assert ops.replayed_counts(path="wgmma")[kernel] == 0
    before = ops.launch_snapshot()
    launch(64, 512, 1024, torch.float32)
    launch(64, 512, 1024, torch.float32)
    launch(64, 512, 1024, torch.bfloat16)
    captured = ops.launches_since(before)
    assert captured == {(kernel, "wgmma", torch.float32): 2,
                        (kernel, "mma.sync", torch.bfloat16): 1}
    assert ops.launch_counts(torch.float32, "wgmma")[kernel] == 2
    assert ops.launch_counts(path="wgmma")[other] == 0
    ops.record_replay(captured)
    ops.record_replay(captured)
    assert ops.replayed_counts(path="wgmma")[kernel] == 4
    assert ops.replayed_counts(torch.float32, "wgmma")[kernel] == 4
    assert ops.replayed_counts(path="mma.sync")[kernel] == 2
    assert ops.replayed_counts()[other] == 0
    assert ops.launch_counts()[kernel] == 3  # replays do not count as launches
    ops.reset_launch_counts()
    assert ops.launch_counts(path="wgmma")[kernel] == 0
    assert ops.replayed_counts(path="wgmma")[kernel] == 0
    assert ops.graph_replays() == 0


@pytest.mark.parametrize("dtype,c,h,wgmma", [
    (torch.float32, 512, 1024, True),  # the rotations trunk
    (torch.float32, 512, 128, True),
    (torch.float32, 512, 2048, True),
    (torch.float32, 512, 960, False),  # H not a multiple of 128
    (torch.float32, 128, 256, False),  # the segments trunk
    (torch.float32, 256, 512, False),
    (torch.bfloat16, 512, 1024, False),
])
def test_k6_path_rule(fake_card, dtype, c, h, wgmma):
    """K6 takes wgmma exactly where K5 does: by the operands' dtype, C and
    H; each launch counts once in the ledger under its path, and K5's
    count does not move."""
    _bwd_launch(100, c, h, dtype)
    path = "wgmma" if wgmma else "mma.sync"
    assert fake_card.calls == ["bwd " + path]
    assert takes_wgmma(dtype, c, h) is wgmma
    assert ops.launch_counts(dtype)["fused_mlp_bwd"] == 1
    assert ops.launch_counts(dtype, path)["fused_mlp_bwd"] == 1
    assert ops.launch_counts(path="wgmma")["fused_mlp_bwd"] == int(wgmma)
    assert ops.launch_counts()["fused_mlp"] == 0


def _fusion_operands(r=6, c=8):
    return (torch.zeros((r, c)), torch.zeros((r, c)), torch.zeros((2, 2 * c)),
            torch.zeros(2))


def test_fusion_counts_in_the_ledger(fake_card):
    """The stream fusion's launches count in ops.launch_counts beside
    K1-K6, on fp32 operands and its one path, the backward's two kernels
    once."""
    x_st, x_ts, w, b = _fusion_operands()
    cuda_fusion.fusion_forward(x_st, x_ts, w, b)
    cuda_fusion.fusion_backward(torch.zeros_like(x_st), x_st, x_ts, torch.zeros((6, 2)), w)
    assert fake_card.calls == ["fusion", "fusion bwd"]
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(stream_fusion=1, stream_fusion_bwd=1)
    assert ops.launch_counts() == ops.launch_counts(torch.float32) == want
    assert ops.launch_counts(path=cuda_fusion.PATH) == want
    assert not any(ops.launch_counts(torch.bfloat16).values())
    assert set(launches.KERNELS["stream_fusion"]["paths"]) == {cuda_fusion.PATH}


def test_record_replay_adds_every_kernel_its_capture_holds(fake_card):
    """A capture's launches (launches_since a snapshot) hold every kernel
    and path it launched, the fusion and both of K5's and K6's paths
    included; each record_replay adds all of them to the replayed count."""
    x_st, x_ts, w, b = _fusion_operands()
    _k5_launch(8, 512, 1024, torch.float32)  # before the capture
    before = ops.launch_snapshot()
    _k5_launch(8, 512, 1024, torch.float32)
    _k5_launch(8, 128, 256, torch.float32)
    _bwd_launch(8, 512, 1024, torch.float32)
    _bwd_launch(8, 512, 1024, torch.bfloat16)
    cuda_fusion.fusion_forward(x_st, x_ts, w, b)
    cuda_fusion.fusion_backward(torch.zeros_like(x_st), x_st, x_ts, torch.zeros((6, 2)), w)
    captured = ops.launches_since(before)
    assert captured == {
        ("fused_mlp", "wgmma", torch.float32): 1,
        ("fused_mlp", "mma.sync", torch.float32): 1,
        ("fused_mlp_bwd", "wgmma", torch.float32): 1,
        ("fused_mlp_bwd", "mma.sync", torch.bfloat16): 1,
        ("stream_fusion", "simt", torch.float32): 1,
        ("stream_fusion_bwd", "simt", torch.float32): 1,
    }
    for _ in range(3):
        ops.record_replay(captured)
    assert ops.graph_replays() == 3
    assert ops.replayed_counts() == {n: 3 * c for n, c in ops.by_kernel(captured).items()}
    assert ops.replayed_counts() == {**dict.fromkeys(launches.KERNELS, 0), "fused_mlp": 6,
                                     "fused_mlp_bwd": 6, "stream_fusion": 3,
                                     "stream_fusion_bwd": 3}
    assert ops.replayed_counts(path="wgmma") == {**dict.fromkeys(launches.KERNELS, 0),
                                                 "fused_mlp": 3, "fused_mlp_bwd": 3}
    assert ops.replayed_counts(torch.bfloat16)["fused_mlp_bwd"] == 3
    assert ops.launch_counts()["fused_mlp"] == 3


def test_a_new_kernel_counts_without_an_edit_to_ops():
    """A kernel the inventory does not list yet counts through
    launches.count alone: ops.launch_counts, the snapshots, replays and the
    reset all take it."""
    ops.reset_launch_counts()
    before = ops.launch_snapshot()
    try:
        launches.count("qkv_gemm", "wgmma", torch.float32)
        launches.count("qkv_gemm", "wgmma", torch.float32)
        assert ops.launch_counts()["qkv_gemm"] == 2
        assert ops.launch_counts(torch.float32, "wgmma")["qkv_gemm"] == 2
        assert ops.launch_counts(torch.bfloat16)["qkv_gemm"] == 0
        assert "qkv_gemm" not in launches.KERNELS
        captured = ops.launches_since(before)
        assert captured == {("qkv_gemm", "wgmma", torch.float32): 2}
        ops.record_replay(captured)
        assert ops.replayed_counts(path="wgmma")["qkv_gemm"] == 2
    finally:
        ops.reset_launch_counts()
    assert "qkv_gemm" not in ops.launch_counts()


@pytest.mark.parametrize("m", [1, 64, 1000, 11475, 66096, 132192])
@pytest.mark.parametrize("h", [512, 1024, 2048])
def test_k6_wgmma_wgrad_splits(m, h):
    """The slices of M K6's wgmma path sums dW over: fixed by the shapes,
    at least one and at most one a 64-row tile, and about 128 work items
    (one round of an H100's SMs) of 256 x 128 tiles of dW1^T and dW2 at
    the trunk's row counts."""
    s = wgmma_wgrad_splits(m, 512, h)
    assert s == wgmma_wgrad_splits(m, 512, h)
    assert 1 <= s <= -(-m // 64)
    items = 2 * 2 * (h // 128) * s
    assert items <= 128
    if m >= 11475:
        assert items == 128


@pytest.mark.parametrize("group", ["MLP_ABLATIONS", "WGMMA_ABLATIONS", "K6_WGMMA_ABLATIONS",
                                   "ATTENTION_VARIANTS", "PACKED_VARIANTS",
                                   "LINEAR_ABLATIONS"])
def test_probe_patch_points_are_in_the_sources(group):
    """run_probes patches copies of the kernels' sources by text: every
    patch point of every variant is in the sources as often as the variant
    replaces it (a kernel rewritten without its patches fails here, not in
    a call to the card)."""
    for name, patches in getattr(run_probes, group).items():
        for file, text, _, count in patches:
            if text is not None:  # None: a probe source the variant includes
                assert (build.CSRC / file).read_text().count(text) >= count, (name, file)


# ---- shapes the kernels are not built for: zero-padded up ----------------

def test_padded_shapes():
    assert [padded_head_dim(d) for d in (4, 8, 12, 64, 65)] == [8, 8, 16, 64, None]
    assert padded_widths(16, 32) == (64, 64)  # tools/h36m_head_to_head.py
    assert padded_widths(32, 64) == (64, 64)  # tools/mup_coord_check.py
    assert padded_widths(512, 1024) == (512, 1024)  # the flagship: no padding
    assert padded_widths(96, 100) == (128, 128)
    assert padded_widths(1024, 2048) is None  # refused on the card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 17, 40])
def test_head_dim_4_pads_exactly(n, dtype):
    """Head dim 4 (the segments trunk of tools/h36m_head_to_head.py) runs
    zero-padded to 8: through the padding, the plain version's output and
    the gradient of the qkv tensor equal the unpadded plain version's bit
    for bit, for the per-window (N <= 32) and the dense (N = 40) route."""
    b, h, d, scale = 3, 4, 4, 0.5
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(dtype).requires_grad_()
    out = attention(qkv, h, scale)
    q, k, v = split_heads(qkv.detach(), h)
    assert out.dtype == dtype
    assert torch.equal(out, merge_heads(attention_plain(q, k, v, scale)))
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(dtype)
    out.backward(g)
    grads = attention_plain_bwd(q, k, v, g.view(b, n, h, d).transpose(1, 2), scale)
    want = torch.stack([t.transpose(1, 2) for t in grads], dim=2)
    assert torch.equal(qkv.grad, want.reshape(qkv.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", [(16, 32), (32, 64)])
def test_narrow_mlp_pads_exactly(c, h, dtype):
    """MLP widths under 64 (C 16 / H 32 of tools/h36m_head_to_head.py's
    segments trunk, C 32 / H 64 of tools/mup_coord_check.py) run
    zero-padded to C 64, H 64: through the padding, the plain version's
    output and all five gradients equal the unpadded plain version's bit
    for bit."""
    args = [a.requires_grad_() for a in _torch_mlp_args(*_mlp_data(544, c, h), dtype)]
    out = fused_mlp(*args)
    plain = [a.detach() for a in args]
    assert out.shape == (544, c) and out.dtype == dtype
    assert torch.equal(out, mlp_plain(*plain))
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(544, c)).astype(np.float32))
    out.backward(g.to(dtype))
    want = mlp_plain_bwd(*plain[:4], g.to(dtype))
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2"), args, want):
        assert a.grad.dtype == dtype and torch.equal(a.grad, w), name


def test_other_devices_raise():
    q = torch.empty(1, 1, 17, 16, device="meta")
    with pytest.raises(ValueError):
        attention_dense(q, q, q, 1.0)
    with pytest.raises(ValueError):
        attention_packed(q, q, q, 1.0)
    x = torch.empty(8, 64, device="meta")
    with pytest.raises(ValueError):
        fused_mlp(x, x, x, x, x)


def test_kernel_build_is_keyed_and_lazy():
    """Nothing builds at import; targets sit in the ignored build directory
    and are keyed by the sources."""
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    for name in build.SIGNATURES:
        target = build._target(name)
        assert target.parent == build.BUILD_DIR and name in target.name
        assert target == build._target(name)
    assert not build._libs


def test_bf16_p_in_two_parts_is_as_accurate_as_fp32():
    """The arithmetic of K1-K4's bf16 products over P and dS (AccMma in
    csrc/attention.cu) on the CPU: P in two bf16 parts, hi = bf16(P) and
    lo = bf16(P - hi), each times the bf16 V summed in fp32, then rounded
    to bf16 as the kernels' outputs are, is within 1.05x of the plain
    version's error against fp64 (P in fp32, as the Pallas kernel keeps
    it); P rounded to one bf16 part, the kernels' arithmetic before the
    repair, is not."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(64, 243, 64, generator=gen).bfloat16() for _ in range(3))
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2) / 8, -1)
    exact = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8, -1) @ v.double()
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()

    def err(out):
        return ((out.bfloat16().double() - exact).norm() / exact.norm()).item()

    plain = err(p @ v.float())
    assert err(hi.float() @ v.float() + lo.float() @ v.float()) <= 1.05 * plain + 1e-6
    assert err(hi.float() @ v.float()) > 1.2 * plain


# ---- the fp32 linear (ops.cuda_linear): plain path, rule, ledger ----------

def _linear_leaves(m, k, n, bias, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((3, m, k), generator=gen)
    w = torch.randn((n, k), generator=gen) / k**0.5
    b = torch.randn((n,), generator=gen) if bias else None
    return [None if t is None else t.requires_grad_() for t in (x, w, b)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,k,n", [(5, 512, 1536), (7, 128, 384), (4, 2, 512)])
def test_linear_plain_path_is_f_linear(m, k, n, bias):
    """On the CPU, cuda_linear.linear is F.linear: its output and the
    gradients of x, W and b, bit for bit, with and without a bias, and
    it launches nothing."""
    ops.reset_launch_counts()
    leaves = _linear_leaves(m, k, n, bias)
    want_leaves = [None if t is None else t.detach().clone().requires_grad_() for t in leaves]
    g = torch.randn((3, m, n), generator=torch.Generator().manual_seed(1))
    got = cuda_linear.linear(*leaves)
    want = torch.nn.functional.linear(*want_leaves)
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    for a, b in zip(leaves, want_leaves):
        if a is not None:
            assert torch.equal(a.grad, b.grad)
    assert not any(ops.launch_counts().values())


def _model_dense(overrides):
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers import instantiate_model
    from manipose_tpu_torch.geometry import h36m_skeleton_17
    from manipose_tpu_torch.models.mix_ste import Dense

    model, _ = instantiate_model(load_config("config", overrides), h36m_skeleton_17())
    return {name: m for name, m in model.named_modules() if isinstance(m, Dense)}


def _rows(name, batch, frames, joints=17, bones=16):
    """The rows a Dense of the flagship or the DSTformer takes in a batch of
    ``batch`` windows: a joint or a bone per frame, one row per frame for
    the segments branch's joint-to-segment embedding."""
    if name.endswith("joints_to_segments_proj"):
        return batch * frames
    return batch * frames * (bones if name.startswith("segments_module") else joints)


# the attention's two products: Attention.qkv and .proj (the DSTformer's
# attn_s and attn_t too)
_QKV_PROJ = (".qkv", ".proj")


def _expected_path(name, rows, k, dtype):
    """qkv and proj at C = 512 (the flagship's rotations trunk, both
    streams of the DSTformer) and the DSTformer's pre_logits on wgmma; the
    segments trunk's C = 128 qkv and proj at and above their crossover; the
    embeddings and heads, bf16 and rows under the crossover on the
    library."""
    wide = name.endswith(_QKV_PROJ) or name == "pre_logits.fc"
    return dtype == torch.float32 and wide and rows >= cuda_linear.min_rows(k)


# (overrides, windows a batch, frames): the flagship's b16 step and lift
# batch, the 3DHP model's batch of 25 at L = 27 and a one-window stream, the
# DSTformer's b32 step
_PATH_CASES = [([], 16, 243), ([], 8, 243), (["data=mpi_inf_3dhp"], 25, 27),
               (["data=mpi_inf_3dhp"], 1, 27), (["model=dstformer", "train=motionbert_ft"], 32, 243)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("overrides,batch,frames", _PATH_CASES)
def test_linear_path_rule_for_every_dense(overrides, batch, frames, dtype):
    """takes_wgmma on every Dense of the flagship, 3DHP and DSTformer models
    at their cells' rows (fake CUDA tensors, so that the rule reads only
    what a card's operands would show): the C = 512 qkv and proj and the
    DSTformer's pre_logits on wgmma; the C = 128 segments trunk wherever its
    rows reach the crossover; every embedding and head, every bf16 call and
    a one-window stream (459 rows) on the library."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dense = _model_dense(overrides)
    assert dense
    picked = {}
    with FakeTensorMode():
        for name, m in dense.items():
            rows = _rows(name, batch, frames)
            x = torch.empty((rows, m.in_features), dtype=dtype, device="cuda")
            w = torch.empty((m.out_features, m.in_features), dtype=dtype, device="cuda")
            picked[name] = cuda_linear.takes_wgmma(x, w)
            assert picked[name] is _expected_path(name, rows, m.in_features, dtype), (name, rows)
    wide = [n for n in dense if n.endswith(_QKV_PROJ)]
    assert len(wide) == 40 and sum(picked[n] for n in wide) == (0 if dtype == torch.bfloat16
                                                                else sum(
        _rows(n, batch, frames) >= cuda_linear.min_rows(dense[n].in_features) for n in wide))
    if dtype == torch.float32 and (batch, frames) in ((16, 243), (32, 243)):
        assert all(picked[n] for n in wide)  # the training cells: every qkv and proj
    if (batch, frames) == (1, 27):
        assert not any(picked.values())  # a one-window stream stays on the library


def test_linear_rule_reads_the_operands():
    """The rule reads the operands alone: fp32 on one CUDA device, K and N
    multiples of 128, M from the crossover up (4096 rows at K = 512, 16,384
    at K = 128); a CPU tensor takes F.linear."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    m = cuda_linear.MIN_ROWS
    assert cuda_linear.min_rows(512) == m == 4096 and cuda_linear.min_rows(128) == 4 * m
    with FakeTensorMode():
        def rule(rows, k, n, dtype=torch.float32, x_device="cuda", w_device="cuda"):
            x = torch.empty((rows, k), dtype=dtype, device=x_device)
            return cuda_linear.takes_wgmma(x, torch.empty((n, k), dtype=dtype, device=w_device))

        assert rule(m, 512, 1536) and rule(4 * m, 128, 128) and rule(2 * m, 256, 640)
        assert not rule(m - 1, 512, 1536) and not rule(4 * m - 1, 128, 384)
        assert not rule(m, 512, 3) and not rule(m, 2, 512) and not rule(m, 512, 1000)
        assert not rule(m, 512, 1536, torch.bfloat16) and not rule(m, 512, 1536, torch.float16)
        assert not rule(m, 512, 1536, x_device="cpu", w_device="cpu")
        x3 = torch.empty((2, m, 512), device="cuda")  # rows are all but the last dim
        assert cuda_linear.takes_wgmma(x3, torch.empty((512, 512), device="cuda"))


def test_linear_kernels_are_listed_under_names_of_their_own():
    """launches.KERNELS lists the linear's device kernels, each a kernel of
    csrc/linear.cu, all named linear_..., and none holds a pattern by which
    benchmark/kernels/*.json counts K1-K6 or the fusion (else
    kernel_roofline would count them as those kernels)."""
    import json

    root = build.CSRC.parents[2]
    patterns = [p for f in sorted((root / "benchmark" / "kernels").glob("*.json"))
                for p in json.loads(f.read_text())["patterns"]]
    assert patterns
    source = (build.CSRC / "linear.cu").read_text()
    names = set()
    for kernel in ("linear", "linear_bwd"):
        entry = launches.KERNELS[kernel]
        assert entry["library"] == "linear" and "wgmma" in entry["paths"]
        names.update(entry["paths"]["wgmma"])
    assert launches.KERNELS["linear"]["paths"]["library"] == ()
    assert names == {"linear_split_kernel", "linear_fwd_kernel", "linear_dx_kernel",
                     "linear_dw_kernel", "linear_reduce_kernel"}
    for name in names:
        assert name.startswith("linear_") and f"\n{name}(" in source, name
        assert not any(p in name for p in patterns), name


@pytest.mark.parametrize("overrides", [[], ["model=dstformer", "train=motionbert_ft"]])
def test_dense_state_dict_names_are_nn_linear_names(overrides):
    """Dense keeps nn.Linear's parameters and state-dict names: every Dense
    of the flagship and the DSTformer holds weight (and bias) as an
    nn.Linear of its widths does, and loads one's state dict strictly."""
    from torch import nn

    for name, m in _model_dense(overrides).items():
        plain = nn.Linear(m.in_features, m.out_features, bias=m.bias is not None)
        assert list(m.state_dict()) == list(plain.state_dict()), name
        m.load_state_dict(plain.state_dict(), strict=True)


class _FakeLinearLibrary:
    def __init__(self):
        self.calls = []

    def mp_linear(self, *args):
        self.calls.append(("fwd",) + args[5:8])
        return 0

    def mp_linear_bwd(self, *args):
        self.calls.append(("bwd",) + args[10:14])
        return 0


def test_linear_counts_its_launches_by_path(monkeypatch):
    """Each fp32 call counts once under ``linear``: on ``wgmma`` where the
    rule takes it (and its backward once under ``linear_bwd``), on
    ``library`` where it leaves it to F.linear; bf16 calls count nothing.
    ops.launch_counts(torch.float32, "wgmma")["linear"] over all fp32 calls
    is the share the kernels took."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    lib = _FakeLinearLibrary()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(cuda_linear, "_check", lambda *args, **kw: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    ops.reset_launch_counts()
    try:
        # the kernels' path on CPU tensors, as if on a card
        rule = cuda_linear.takes_wgmma
        monkeypatch.setattr(cuda_linear, "takes_wgmma",
                            lambda x, w: w.shape[0] % 128 == 0 and w.shape[1] % 128 == 0)
        x, w, b = _linear_leaves(4, 512, 1536, True)
        cuda_linear.linear(x, w, b).sum().backward()
        with torch.no_grad():
            cuda_linear.linear(x, w)  # the operator, no gradient
        assert lib.calls == [("fwd", 12, 1536, 512), ("bwd", 12, 1536, 512, 1),
                             ("fwd", 12, 1536, 512)]
        monkeypatch.setattr(cuda_linear, "takes_wgmma", rule)
        # the library's path: fp32 on a (fake) card below the crossover
        with FakeTensorMode():
            for dtype in (torch.float32, torch.bfloat16):
                cuda_linear.linear(torch.empty((459, 512), dtype=dtype, device="cuda"),
                                   torch.empty((1536, 512), dtype=dtype, device="cuda"))
        assert ops.launch_counts(torch.float32, "wgmma")["linear"] == 2
        assert ops.launch_counts(torch.float32, "wgmma")["linear_bwd"] == 1
        assert ops.launch_counts(torch.float32, "library")["linear"] == 1
        assert ops.launch_counts(torch.float32)["linear"] == 3
        assert not any(ops.launch_counts(torch.bfloat16).values())
    finally:
        ops.reset_launch_counts()


@pytest.mark.parametrize("m", [1, 459, 4096, 33048, 66096, 132192])
@pytest.mark.parametrize("n,k", [(1536, 512), (512, 512), (384, 128)])
def test_linear_wgrad_splits(m, n, k):
    """The slices of M the dW kernel sums over: fixed by the shapes, at
    least one and each at least WGRAD_MIN_ROWS rows where M allows, and at
    most WGRAD_ITEMS work items of 256 x 128 tiles of dW and slices (two
    rounds of an H100's SMs), filling them at the cells' rows."""
    s = cuda_linear.wgrad_splits(m, n, k)
    assert s == cuda_linear.wgrad_splits(m, n, k) and s >= 1
    assert s <= max(1, -(-m // cuda_linear.WGRAD_MIN_ROWS))
    per_slice = -(-n // 256) * (k // 128)
    assert s * per_slice <= max(per_slice, cuda_linear.WGRAD_ITEMS)
    if m >= 66096:
        assert s * per_slice > cuda_linear.WGRAD_ITEMS - per_slice


def test_linear_launchers_refuse_what_the_kernels_do_not_take():
    """The launchers check the operands before any pointer reaches the
    library: CPU or bf16 operands, K or N off the tiles, mismatched shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def empty(*shape, dtype=torch.float32, device="cuda"):
        return torch.empty(shape, dtype=dtype, device=device)

    with FakeTensorMode():
        x, w = empty(64, 512), empty(512, 512)
        for args in ((empty(64, 512, device="cpu"), empty(512, 512, device="cpu")),
                     (empty(64, 512, dtype=torch.bfloat16), empty(512, 512, dtype=torch.bfloat16)),
                     (empty(64, 100), empty(512, 100)), (x, empty(200, 512)),
                     (x, empty(512, 384))):
            with pytest.raises(ValueError):
                cuda_linear.linear_forward(*args, None)
        with pytest.raises(ValueError, match="b"):
            cuda_linear.linear_forward(x, w, empty(256))
        with pytest.raises(ValueError, match="g"):
            cuda_linear.linear_backward(x, w, empty(64, 256))
