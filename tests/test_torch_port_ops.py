"""PyTorch port vs the JAX package: the plain versions of the port's
kernels against the Pallas kernels (interpret mode on the CPU), device
dispatch and launch counting. The kernels themselves are checked on the
card by tests/test_torch_port_cuda.py and chip_smoke.py."""

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
    attention_dense,
    attention_packed,
    attention_plain,
)
from manipose_tpu_torch.ops.cuda_mlp import fused_mlp, mlp_plain, round_to_tf32

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
    }


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
