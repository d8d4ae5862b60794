"""Fused MLP kernels K5 (forward) and K6 (backward): wrappers, plain
PyTorch versions, the autograd Function and launch counters.

``fused_mlp`` replaces ``manipose_tpu/ops/pallas_mlp.py::fused_mlp``:
gelu_exact(x W1^T + b1) W2^T + b2 with fp32 accumulation and the (M, H)
intermediate kept on chip. ``fused_mlp_bwd`` (K6) is the ``custom_vjp``
half ``_backward``. The kernels are in ``csrc/mlp.cu``: every product on
the tensor cores (mma.sync), bf16 in one pass, fp32 as 3xTF32 within the
JAX package's fp32 tolerances. Weights are in torch ``nn.Linear`` layout:
w1 (H, C), w2 (C, H).

``fused_mlp`` is differentiable: when a gradient is wanted it runs
:class:`FusedMLP`, which saves x, w1, b1 and w2 (as the JAX VJP does) and
whose backward is K6; otherwise it launches K5 alone. Widths the kernels
are not built for (C under 512 and not in ``CHANNELS``, H not a multiple
of 64) are zero-padded up to the next built shape: zero columns of x and
W1 leave x W1^T unchanged, a zero hidden unit is gelu(0) = 0 through zero
weights, and the padded output columns are sliced away, as autograd
slices the gradients.

A CPU tensor takes the plain version, a CUDA tensor launches the kernel
(or the call raises).

K5 is also a PyTorch operator, ``manipose::mlp_forward``
(``torch.library.custom_op``), which :func:`fused_mlp` calls when no
gradient is wanted; its fake version lets ``torch.export`` record it in a
program, which launches K5 when it runs on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNELS = (64, 128, 256, 512)
HIDDEN_TILE = 64
ROW_TILE = 64
# K6 sums dW over M in fp32 partials of a fixed split of M: enough slices to
# give ~512 blocks of 128 x 128 output tiles, each at least WGRAD_MIN_ROWS
# rows long
WGRAD_TILE = 128
WGRAD_BLOCKS = 512
WGRAD_MIN_ROWS = 256

# launches per kernel and operand dtype; reset by ``ops.reset_launch_counts``
LAUNCHES = {name: dict.fromkeys(KERNEL_DTYPES, 0)
            for name in ("fused_mlp", "fused_mlp_bwd")}
# launches made by CUDA-graph replays (``ops.record_replay``), likewise
REPLAYED = {name: dict.fromkeys(KERNEL_DTYPES, 0) for name in LAUNCHES}


def mlp_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """x: (M, C) -> (M, C), fp32 accumulation. Under bf16 the GELU output
    is rounded to bf16 before fc2, as the kernel (and pallas_mlp.py:86)
    does."""
    a = F.linear(x.float(), w1.float(), b1.float())
    h = F.gelu(a).to(x.dtype).float()
    return F.linear(h, w2.float(), b2.float()).to(x.dtype)


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to nearest with
    ties away from zero, keeping 10 of the 23 mantissa bits. The CPU's
    model of the fp32 kernels' 3xTF32 split, big = tf32(x) and small =
    tf32(x - big). The kernels round big to nearest by Veltkamp's split
    (the same but at ties) and let the mma truncate small; the error of
    either is far inside the fp32 tolerances."""
    bits = x.float().view(torch.int32)
    magnitude = bits & 0x7FFFFFFF
    finite = magnitude < 0x7F800000
    rounded = torch.where(finite, (bits + 0x1000) & ~0x1FFF, bits)
    return rounded.view(torch.float32)


def _gelu_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu_exact / da = Phi(a) + a phi(a)."""
    cdf = 0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))
    return cdf + a * torch.exp(-0.5 * a * a) * (1.0 / math.sqrt(2.0 * math.pi))


def mlp_plain_bwd(x, w1, b1, w2, g):
    """The gradient of :func:`mlp_plain` for the output gradient g, step by
    step as ``pallas_mlp.py::_bwd_kernel`` takes it: recompute a and
    gelu(a) from x; dh = g W2, da = dh * gelu'(a), dX = da W1, dW1 = da^T x,
    dW2 = g^T gelu(a), db1 = sum(da), db2 = sum(g). In bf16 it rounds where
    the TPU kernel rounds (gelu(a), g and da before the products) and sums
    dW/db in fp32 before casting to the weights' dtype. No autograd.
    -> (dx, dw1, db1, dw2, db2)."""
    dt = x.dtype
    x32 = x.float()
    a = F.linear(x32, w1.float(), b1.float())
    hh = F.gelu(a).to(dt).float()
    g32 = g.to(dt).float()
    da = torch.matmul(g32, w2.float()) * _gelu_grad(a)
    da_c = da.to(dt).float()
    dx = torch.matmul(da_c, w1.float()).to(dt)
    dw1 = torch.matmul(da_c.t(), x32).to(w1.dtype)
    dw2 = torch.matmul(g32.t(), hh).to(w2.dtype)
    # the bias sums are products with a ones vector, like the weight sums,
    # so zero-padded columns leave every other column's sum bit for bit
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    db1 = torch.matmul(da.t(), ones).to(b1.dtype)
    db2 = torch.matmul(g.float().t(), ones).to(w2.dtype)
    return dx, dw1, db1, dw2, db2


def _check(x, w1, b1, w2, b2=None) -> None:
    ts = tuple(t for t in (x, w1, b1, w2, b2) if t is not None)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("all MLP operands must lie on one CUDA device")
    if x.dtype not in KERNEL_DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"the MLP kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError("x must be (M, C)")
    m, c = x.shape
    h = w1.shape[0]
    if c not in CHANNELS:
        raise ValueError(f"channels {c} not in {CHANNELS}")
    if h % HIDDEN_TILE or w1.shape != (h, c) or w2.shape != (c, h) \
            or b1.shape != (h,) or (b2 is not None and b2.shape != (c,)):
        raise ValueError(
            f"need w1 (H, {c}), b1 (H,), w2 ({c}, H), b2 ({c},) with H a "
            f"multiple of {HIDDEN_TILE}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("MLP operands must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("MLP operands must start on a 16-byte boundary")


def _plain_or_raise(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no MLP kernel for device {x.device}")
    return False


def mlp_forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """K5: x (M, C) -> gelu(x w1^T + b1) w2^T + b2, (M, C). Not
    differentiable on the card: :func:`fused_mlp` is."""
    if _plain_or_raise(x):
        return mlp_plain(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(
            "the MLP kernel is not differentiable on its own; call fused_mlp"
        )
    m, c = x.shape
    out = torch.empty_like(x)
    lib = build.load("mlp")
    err = lib.mp_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), KERNEL_DTYPES[x.dtype],
        m, c, w1.shape[0], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "mp_fused_mlp")
    LAUNCHES["fused_mlp"][x.dtype] += 1
    return out


@torch.library.custom_op("manipose::mlp_forward", mutates_args=())
def mlp_forward_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`mlp_forward` (K5) as an operator."""
    return mlp_forward(x, w1, b1, w2, b2)


@mlp_forward_op.register_fake
def _mlp_forward_fake(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


def wgrad_splits(m: int, c: int, h: int) -> int:
    """How many slices of M K6 sums its weight gradients over (fixed by the
    shapes, so repeated runs sum in one order)."""
    tiles = -(-h // WGRAD_TILE) * -(-c // WGRAD_TILE)
    return max(1, min(-(-m // WGRAD_MIN_ROWS), -(-WGRAD_BLOCKS // tiles)))


def fused_mlp_bwd(x, w1, b1, w2, g):
    """K6: the gradient of K5 for the output gradient g (M, C).
    -> (dx, dw1, db1, dw2, db2), each of its operand's shape and dtype."""
    if _plain_or_raise(x):
        return mlp_plain_bwd(x, w1, b1, w2, g)
    _check(x, w1, b1, w2)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be a contiguous (M, C) tensor like x")
    m, c = x.shape
    h = w1.shape[0]
    s = wgrad_splits(m, c, h)
    blocks = -(-m // ROW_TILE)
    dx = torch.empty_like(x)
    da = torch.empty((m, h), dtype=x.dtype, device=x.device)
    hh = torch.empty((m, h), dtype=x.dtype, device=x.device)
    colsum = torch.empty((blocks, 2 * h + c), dtype=torch.float32, device=x.device)
    part = torch.empty((s, 2 * h * c), dtype=torch.float32, device=x.device)
    grads = torch.empty((2 * h * c + h + c,), dtype=x.dtype, device=x.device)
    lib = build.load("mlp")
    err = lib.mp_fused_mlp_bwd(
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), dx.data_ptr(), da.data_ptr(), hh.data_ptr(),
        colsum.data_ptr(), part.data_ptr(), grads.data_ptr(), KERNEL_DTYPES[x.dtype], m, c, h, s,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "mp_fused_mlp_bwd")
    LAUNCHES["fused_mlp_bwd"][x.dtype] += 1
    dw1, db1, dw2, db2 = torch.split(grads, [h * c, h, c * h, c])
    return dx, dw1.view(h, c), db1, dw2.view(c, h), db2


class FusedMLP(torch.autograd.Function):
    """K5 forward, K6 backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return mlp_forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return fused_mlp_bwd(*ctx.saved_tensors, g.contiguous())


def padded_widths(c: int, h: int):
    """(C, H) of the kernel that runs an MLP of C channels and H hidden
    units: C up to the next width in ``CHANNELS``, H up to a multiple of
    ``HIDDEN_TILE``; None past the widest channel count."""
    cp = next((w for w in CHANNELS if w >= c), None)
    return None if cp is None else (cp, -(-h // HIDDEN_TILE) * HIDDEN_TILE)


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (M, C) -> gelu(x w1^T + b1) w2^T + b2, (M, C), differentiable."""
    c, h = x.shape[-1], w1.shape[0]
    padded = padded_widths(c, h)
    if padded is not None and padded != (c, h):
        pc, ph = padded[0] - c, padded[1] - h
        y = fused_mlp(F.pad(x, (0, pc)), F.pad(w1, (0, pc, 0, ph)),
                      F.pad(b1, (0, ph)), F.pad(w2, (0, ph, 0, pc)),
                      F.pad(b2, (0, pc)))
        return y[:, :c]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return FusedMLP.apply(x, w1, b1, w2, b2)
    _plain_or_raise(x)  # the operator would run its fake on another device
    return mlp_forward_op(x, w1, b1, w2, b2)
