"""Fused MLP kernels K5 (forward) and K6 (backward): wrappers, plain
PyTorch versions, the autograd Function and one launcher per path.

``fused_mlp`` replaces ``manipose_tpu/ops/pallas_mlp.py::fused_mlp``:
gelu_exact(x W1^T + b1) W2^T + b2 with fp32 accumulation and the (M, H)
intermediate kept on chip. ``fused_mlp_bwd`` (K6) is the ``custom_vjp``
half ``_backward``. The kernels are in ``csrc/mlp.cu``: every product on
the tensor cores, bf16 in one pass, fp32 as 3xTF32 within the JAX
package's fp32 tolerances. Weights are in torch ``nn.Linear`` layout:
w1 (H, C), w2 (C, H).

K5 has two kernels and :func:`takes_wgmma` picks one from the operands'
dtype and widths: fp32 at C = 512 with H a multiple of 128 (the rotations
trunk) runs on wgmma fed by TMA (``fused_mlp_kernel_sm90``, after
``fused_mlp_kernel_split`` writes the weights' tf32 planes into scratch);
every other launch (bf16, the segments trunk's C = 128) runs the mma.sync
kernel. The row count plays no part: on an H100 the wgmma kernel is the
faster from one 64-row tile up (PERF.md, K5's rows). K6 follows the same
rule: the launches it takes run on wgmma fed by TMA (the rows pass
``fused_mlp_bwd_rows_kernel_sm90`` and the tile products
``fused_mlp_bwd_gemm_kernel_dx`` and ``_dw``), every other launch on the
mma.sync kernels.

Each path has one launcher (``K5_LAUNCHERS``, ``K6_LAUNCHERS``): it holds
the path's scratch, its entry point's arguments, the error check and the
count in ``launches`` under the path's name, and takes the loaded library
(the built one by default), so a caller can force a path or launch an
ablated build of the sources.

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

from . import build, launches

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

# the widths K5's and K6's wgmma kernels take: C, and H in multiples of
WGMMA_CHANNELS = 512
WGMMA_HIDDEN_TILE = 128
# K6's wgmma path: its rows pass's tile of M, and about how many work
# items (256 x 128 output tiles of dW1^T and dW2 and slices of M together;
# one round of an H100's 132 SMs) it sums dW over
WGMMA_ROW_TILE = 128
WGMMA_WGRAD_TILE = (256, 128)
WGMMA_WGRAD_ITEMS = 128

launches.register("mlp", {
    "fused_mlp": {"wgmma": ("fused_mlp_kernel_split", "fused_mlp_kernel_sm90"),
                  "mma.sync": ("fused_mlp_kernel",)},
    "fused_mlp_bwd": {
        "wgmma": ("fused_mlp_bwd_rows_kernel_split", "fused_mlp_bwd_rows_kernel_sm90",
                  "fused_mlp_bwd_gemm_kernel_dx", "fused_mlp_bwd_gemm_kernel_dw",
                  "fused_mlp_bwd_reduce_kernel_sm90"),
        "mma.sync": ("fused_mlp_bwd_rows_kernel", "fused_mlp_bwd_gemm_kernel",
                     "fused_mlp_bwd_reduce_kernel")},
})


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


def takes_wgmma(dtype: torch.dtype, c: int, h: int) -> bool:
    """Whether K5 and K6 run on wgmma for C channels of ``dtype`` and H
    hidden units: fp32 at C = 512 with H a multiple of 128."""
    return (dtype == torch.float32 and c == WGMMA_CHANNELS
            and h % WGMMA_HIDDEN_TILE == 0)


def _ptrs(*ts) -> tuple:
    return tuple(t.data_ptr() for t in ts)


def _launch(lib, entry: str, kernel: str, path: str, x, *args) -> None:
    """Call ``entry`` of ``lib`` (the built library when None) with
    ``args``, the device and the stream; check it and count the launch."""
    lib = build.load("mlp") if lib is None else lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib, getattr(lib, entry)(*args, x.device.index, stream), entry)
    launches.count(kernel, path, x.dtype)


def _k5_wgmma(x, w1, b1, w2, b2, lib=None) -> torch.Tensor:
    """K5 on wgmma (fp32, C = 512); the weights' big and small tf32 planes
    are scratch the launch writes."""
    m, c = x.shape
    h = w1.shape[0]
    out = torch.empty_like(x)
    w1p = torch.empty((2 * h, c), dtype=x.dtype, device=x.device)
    w2p = torch.empty((2 * c, h), dtype=x.dtype, device=x.device)
    _launch(lib, "mp_fused_mlp_sm90", "fused_mlp", "wgmma", x,
            *_ptrs(x, w1, b1, w2, b2, out, w1p, w2p), m, h)
    return out


def _k5_mma_sync(x, w1, b1, w2, b2, lib=None) -> torch.Tensor:
    """K5 on mma.sync, any built width and dtype."""
    m, c = x.shape
    out = torch.empty_like(x)
    _launch(lib, "mp_fused_mlp", "fused_mlp", "mma.sync", x,
            *_ptrs(x, w1, b1, w2, b2, out), KERNEL_DTYPES[x.dtype], m, c, w1.shape[0])
    return out


K5_LAUNCHERS = {"wgmma": _k5_wgmma, "mma.sync": _k5_mma_sync}


def mlp_forward(x, w1, b1, w2, b2) -> torch.Tensor:
    """K5: x (M, C) -> gelu(x w1^T + b1) w2^T + b2, (M, C), on the kernel
    :func:`takes_wgmma` picks. Not differentiable on the card:
    :func:`fused_mlp` is."""
    if _plain_or_raise(x):
        return mlp_plain(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError(
            "the MLP kernel is not differentiable on its own; call fused_mlp"
        )
    launch = _k5_wgmma if takes_wgmma(x.dtype, x.shape[1], w1.shape[0]) else _k5_mma_sync
    return launch(x, w1, b1, w2, b2)


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


def wgmma_wgrad_splits(m: int, c: int, h: int) -> int:
    """How many slices of M K6's wgmma path sums its weight gradients over:
    about WGMMA_WGRAD_ITEMS items of WGMMA_WGRAD_TILE output tiles of dW1^T
    and dW2 (C, H) and slices, each slice at least one 64-row tile (fixed
    by the shapes)."""
    per_slice = 2 * (c // WGMMA_WGRAD_TILE[0]) * (h // WGMMA_WGRAD_TILE[1])
    return max(1, min(-(-m // ROW_TILE), WGMMA_WGRAD_ITEMS // per_slice))


def _k6_launch(lib, entry: str, path: str, x, w1, b1, w2, g, scratch, *sizes):
    """K6's ``entry`` with its ``scratch``. -> (dx, dw1, db1, dw2, db2)."""
    c, h = x.shape[1], w1.shape[0]
    dx = torch.empty_like(x)
    grads = torch.empty((2 * h * c + h + c,), dtype=x.dtype, device=x.device)
    _launch(lib, entry, "fused_mlp_bwd", path, x,
            *_ptrs(x, g, w1, b1, w2, dx, *scratch, grads), *sizes)
    dw1, db1, dw2, db2 = torch.split(grads, [h * c, h, c * h, c])
    return dx, dw1.view(h, c), db1, dw2.view(c, h), db2


def _k6_wgmma(x, w1, b1, w2, g, lib=None):
    """K6 on wgmma (fp32, C = 512). Its scratch: da^T's and gelu(a)^T's tf32
    planes, k-major for the weight sums, over M rounded up to a row tile;
    the weights' planes; column sums; the weight sums' partials over
    :func:`wgmma_wgrad_splits` slices of M."""
    m, c = x.shape
    h = w1.shape[0]
    s = wgmma_wgrad_splits(m, c, h)
    tiles = -(-m // WGMMA_ROW_TILE)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = (torch.empty((4 * h, tiles * WGMMA_ROW_TILE), **f32),
               torch.empty((6 * h * c,), **f32), torch.empty((tiles, 4 * h + c), **f32),
               torch.empty((s, 2 * h * c), **f32))
    return _k6_launch(lib, "mp_fused_mlp_bwd_sm90", "wgmma", x, w1, b1, w2, g, scratch,
                      m, h, s)


def _k6_mma_sync(x, w1, b1, w2, g, lib=None):
    """K6 on mma.sync, any built width and dtype."""
    m, c = x.shape
    h = w1.shape[0]
    s = wgrad_splits(m, c, h)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = (torch.empty((m, h), dtype=x.dtype, device=x.device),
               torch.empty((m, h), dtype=x.dtype, device=x.device),
               torch.empty((-(-m // ROW_TILE), 2 * h + c), **f32),
               torch.empty((s, 2 * h * c), **f32))  # da, gelu(a), column sums, partials
    return _k6_launch(lib, "mp_fused_mlp_bwd", "mma.sync", x, w1, b1, w2, g, scratch,
                      KERNEL_DTYPES[x.dtype], m, c, h, s)


K6_LAUNCHERS = {"wgmma": _k6_wgmma, "mma.sync": _k6_mma_sync}


def fused_mlp_bwd(x, w1, b1, w2, g):
    """K6: the gradient of K5 for the output gradient g (M, C), on the
    kernels :func:`takes_wgmma` picks.
    -> (dx, dw1, db1, dw2, db2), each of its operand's shape and dtype."""
    if _plain_or_raise(x):
        return mlp_plain_bwd(x, w1, b1, w2, g)
    _check(x, w1, b1, w2)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("g must be a contiguous (M, C) tensor like x")
    launch = _k6_wgmma if takes_wgmma(x.dtype, x.shape[1], w1.shape[0]) else _k6_mma_sync
    return launch(x, w1, b1, w2, g)


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
