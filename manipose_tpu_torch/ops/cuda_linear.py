"""The fp32 linear of the trunks' attention (qkv and proj) on wgmma: the
wrapper, its plain version, the autograd Function and the rule that picks
the kernel.

:func:`linear` does what ``F.linear`` does, y = x W^T + b, and its
backward what autograd gives for it: dX = dY W, dW = dY^T x, db = the
column sums of dY. The kernels are in ``csrc/linear.cu`` (``mp_linear``,
``mp_linear_bwd``): every product on the tensor cores as 3xTF32, each
stage of 32 of k in a fresh accumulator added into fp32 sums, so the
result keeps fp32 accuracy where the library's fp32 GEMMs (TF32 off) run
on the FMA units. It replaces no TPU kernel: the JAX package's ``Dense``
is XLA's dot.

:func:`takes_wgmma` decides from what the operands show: fp32 on one
CUDA device, K and N multiples of 128 (``TILE``), and at least
:func:`min_rows` rows, below which the library is the faster on an H100
(PERF.md, the linear's row): 4096 at K = 512, 16,384 at K = 128. That
takes every C = 512 trunk's qkv and proj and the DSTformer's
``pre_logits`` at the cells' sizes, and the segments trunk's C = 128 qkv
and proj from 5 windows of 243 frames; the embeddings (K = 2 or 3), the
heads (N = 3 or 1), bf16 compute (the library's bf16 GEMMs are on the
tensor cores already) and a one-window stream at L = 27 (459 rows) stay on
``F.linear``. Under ``torch.export`` with a symbolic batch the kernels are
taken only where every batch reaches the crossover. A CPU tensor runs
``F.linear``, the plain version.

Every fp32 call on the card counts in the launch ledger (``launches``) as
kernel ``linear``, on path ``wgmma`` or, where the rule leaves it to
``F.linear``, ``library``; the backward's launches count as
``linear_bwd`` on ``wgmma``. The launchers, :func:`linear_forward` and
:func:`linear_backward`, take the loaded library (the built one by
default), so a caller can launch an ablated build of the sources.

When no gradient is wanted, :func:`linear` calls the PyTorch operator
``manipose::linear`` (``torch.library.custom_op``), whose fake version lets
``torch.export`` record it in a program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.fx.experimental.symbolic_shapes import statically_known_true

from . import build, launches

# K and N in multiples of: the kernels' 128-column output tiles
TILE = 128
# rows from which the kernels' forward and backward beat the library's
# fp32 GEMMs on an H100 at K = 512 (qkv's N = 1536 from 2048 rows, proj's
# 512 from 3072); the crossover grows as K shrinks, about as 1 / K (at K =
# 128 between 6144 and 16,384 rows by N; PERF.md)
MIN_ROWS = 4096
# dW sums over a fixed split of M: about WGRAD_ITEMS work items (256 x 128
# tiles of dW and slices of M together; two rounds of an H100's 132 SMs),
# each slice at least WGRAD_MIN_ROWS long
WGRAD_TILE = (256, 128)
WGRAD_ITEMS = 264
WGRAD_MIN_ROWS = 256
# x^T's planes take M rounded up to this many rows (the kernels' stage)
ROW_STAGE = 32

launches.register("linear", {
    "linear": {"wgmma": ("linear_split_kernel", "linear_fwd_kernel"), "library": ()},
    "linear_bwd": {"wgmma": ("linear_split_kernel", "linear_dx_kernel", "linear_dw_kernel",
                             "linear_reduce_kernel")},
})


def linear_plain(x, w, b=None) -> torch.Tensor:
    """The plain version: ``F.linear``."""
    return F.linear(x, w, b)


def min_rows(k: int) -> int:
    """The crossover: rows from which the kernels take a product over K."""
    return -(-MIN_ROWS * 512 // k)


def takes_wgmma(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``linear(x, w, b)`` runs the kernels: fp32 x (..., K) and w
    (N, K) on one CUDA device, K and N multiples of ``TILE``, and at least
    :func:`min_rows` rows of x (for a symbolic row count, at every value it
    may take)."""
    if not (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32
            and w.device == x.device and w.dim() == 2 and x.dim() >= 1):
        return False
    n, k = w.shape
    if x.shape[-1] != k or k % TILE or n % TILE:
        return False
    return statically_known_true(x.numel() >= min_rows(k) * k)


def wgrad_splits(m: int, n: int, k: int) -> int:
    """How many slices of M the dW kernel sums over (fixed by the shapes,
    so repeated runs sum in one order)."""
    per_slice = -(-n // WGRAD_TILE[0]) * (k // WGRAD_TILE[1])
    return max(1, min(-(-m // WGRAD_MIN_ROWS), WGRAD_ITEMS // per_slice))


def _check(x, w, b=None, g=None) -> None:
    """Raise on operands the kernels do not take: x (M, K), w (N, K), b
    (N) and g (M, N), fp32 on x's CUDA device, K and N multiples of TILE."""
    ts = [t for t in (x, w, b, g) if t is not None]
    if not all(t.is_cuda and t.device == x.device and t.dtype == torch.float32 for t in ts):
        raise ValueError("the linear's operands must be fp32 on one CUDA device")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] \
            or w.shape[0] % TILE or w.shape[1] % TILE:
        raise ValueError(f"need x (M, K) and w (N, K) with K and N multiples of {TILE}, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if (b is not None and b.shape != (w.shape[0],)) or (
            g is not None and g.shape != (x.shape[0], w.shape[0])):
        raise ValueError("need b (N,) and g (M, N)")


def _operand(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` as the kernels read it: contiguous from a 16-byte boundary (a
    copy where it is not, as TMA and the vector loads need)."""
    if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(lib, entry: str, kernel: str, x, *args) -> None:
    """Call ``entry`` of ``lib`` (the built library when None) with
    ``args``, the device and the stream; check it and count the launch."""
    lib = build.load("linear") if lib is None else lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(lib, getattr(lib, entry)(*args, x.device.index, stream), entry)
    launches.count(kernel, "wgmma", x.dtype)


def linear_forward(x, w, b, lib=None) -> torch.Tensor:
    """y (M, N) = x (M, K) w^T + b on the kernels; W's tf32 planes are
    scratch the launch writes."""
    _check(x, w, b)
    x, w, b = (_operand(t) for t in (x, w, b))
    m, k = x.shape
    n = w.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    wp = torch.empty((2 * n, k), dtype=x.dtype, device=x.device)
    _launch(lib, "mp_linear", "linear", x, _ptr(x), _ptr(w), _ptr(b), _ptr(y), _ptr(wp),
            m, n, k)
    return y


def linear_backward(x, w, g, lib=None):
    """(dx, dw, db) of y = x w^T + b for dY = g (M, N). Scratch: W^T's and
    x^T's tf32 planes, and dW's and db's partials over
    :func:`wgrad_splits` slices of M."""
    _check(x, w, g=g)
    x, w, g = (_operand(t) for t in (x, w, g))
    m, k = x.shape
    n = w.shape[0]
    s = wgrad_splits(m, n, k)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty((n,), **f32)
    scratch = (torch.empty((2 * k, n), **f32),
               torch.empty((2 * k, -(-m // ROW_STAGE) * ROW_STAGE), **f32),
               torch.empty((s, n, k), **f32), torch.empty((s, n), **f32))
    _launch(lib, "mp_linear_bwd", "linear_bwd", x,
            *(_ptr(t) for t in (x, w, g, dx, dw, db, *scratch)), m, n, k, s)
    return dx, dw, db


class Linear(torch.autograd.Function):
    """The kernels' forward and backward on x (M, K), w (N, K), b (N) or
    None."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return linear_forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw, db = linear_backward(x, w, g)
        return dx, dw, db if ctx.has_bias else None


@torch.library.custom_op("manipose::linear", mutates_args=())
def linear_op(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' forward as an operator: x (M, K) -> (M, N)."""
    return linear_forward(x, w, b)


@linear_op.register_fake
def _linear_fake(x, w, b):
    return x.new_empty((x.shape[0], w.shape[0]))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)``, differentiable, on the kernels where
    :func:`takes_wgmma` says so."""
    if not takes_wgmma(x, w):
        if x.is_cuda and x.dtype == torch.float32:
            launches.count("linear", "library", torch.float32)
        return linear_plain(x, w, b)
    n, k = w.shape
    x2 = x.reshape(-1, k)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x2, w, b)):
        y = Linear.apply(x2, w, b)
    else:
        y = linear_op(x2, w, b)
    return y.reshape(*x.shape[:-1], n)
