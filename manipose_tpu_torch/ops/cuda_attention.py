"""Attention kernels K1/K2 (dense) and K3/K4 (per-window, tiny N):
wrappers, plain PyTorch versions, autograd Functions and launch counters.

``attention_dense`` replaces ``manipose_tpu/ops/pallas_attention.py::
flash_attention`` (temporal layout, N = 243 frames) and
``attention_packed`` replaces ``flash_attention_packed`` (spatial layout,
N = 16 bones or 17 joints). Both compute softmax(scale * Q K^T) V per
(batch, head) with fp32 accumulation. ``attention_dense_bwd`` (K2) and
``attention_packed_bwd`` (K4) are their backward kernels, the
``custom_vjp`` halves ``_forward_bwd`` and ``_packed_forward_bwd``. The
kernels are in ``csrc/attention.cu``.

:func:`attention` is the differentiable entry the model calls: it takes the
qkv projection (B, N, 3*h*d) and returns the merged heads (B, N, h*d).
When a gradient is wanted it runs :class:`DenseAttention` or
:class:`PackedAttention`, whose backward writes dq, dk and dv straight into
one gradient of qkv; otherwise it launches the forward kernel alone, and
K1 writes no log-sum-exp.

Dispatch depends on the device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or the call raises). The plain
versions double as the reference that the kernels are held against.

The forward kernels are also PyTorch operators, ``manipose::attention_dense``
and ``manipose::attention_packed`` (``torch.library.custom_op``), which
:func:`attention` calls when no gradient is wanted. Their fake versions give
the real output's shape and strides, so ``torch.export`` records the
operators in a program (the ctypes launches stay inside them) and the
program launches the kernels when it runs on the card, once this module is
imported.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are built for (8 is model=small's: 64 channels, 8
# heads); :func:`attention` pads smaller ones up
HEAD_DIMS = (8, 16, 32, 64)
PACKED_MAX_N = 32

# launches per kernel and operand dtype; reset by ``ops.reset_launch_counts``
LAUNCHES = {name: dict.fromkeys(KERNEL_DTYPES, 0)
            for name in ("attention_dense", "attention_packed",
                         "attention_dense_bwd", "attention_packed_bwd")}


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v in fp32, cast back to q's dtype.
    q, k, v: (B, h, N, d) -> (B, h, N, d)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def attention_plain_bwd(q, k, v, do, scale: float):
    """The gradient of :func:`attention_plain`, step by step as
    ``pallas_attention.py::_bwd_kernel`` takes it: recompute P from q and
    k, then dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
    dQ = dS K * scale, dK = dS^T Q * scale. fp32, cast to q's dtype; no
    autograd. q, k, v, do: (B, h, N, d) -> (dq, dk, dv)."""
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    probs = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)) * scale, -1)
    dv = torch.matmul(probs.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _check(q, k, v, max_n=None) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernels take fp32 or bf16, got {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one (B, h, N, d) shape")
    n, d = q.shape[2], q.shape[3]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if max_n is not None and n > max_n:
        raise ValueError(f"the per-window kernel takes N <= {max_n}, got {n}")
    _check_rows(q, (k, v), "q, k and v")


def _check_rows(t, others, what: str) -> None:
    """``others`` share ``t``'s strides; rows are contiguous and every
    stride and start is 16-byte aligned (the kernels copy 16 bytes at a
    time)."""
    if any(o.stride() != t.stride() for o in others):
        raise ValueError(f"{what} must share strides (views of one tensor)")
    if t.stride(3) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
        raise ValueError(f"{what} rows must be contiguous and 16-byte aligned")
    for o in (t, *others):
        if o.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary")


def _check_grad_inputs(q, tensors, what: str) -> None:
    """Backward operands other than q, k, v: same device, dtype and shape
    as q, and (B, h, N, d) views with the kernels' alignment."""
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{what} must match q's device, dtype and shape")
    _check_rows(tensors[0], tensors[1:], what)


def _refuse_grad(*ts) -> None:
    """A kernel's output has no ``grad_fn``: refuse to cut a gradient
    silently. Differentiable calls go through :func:`attention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the attention kernels are not differentiable on their own; "
            "call cuda_attention.attention on the qkv tensor"
        )


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _plain_or_raise(q) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return False


def _empty_out(q) -> torch.Tensor:
    """(B, h, N, d) view of a new (B, N, h, d) tensor."""
    b, h, n, d = q.shape
    return torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)


def _empty_dqkv(q) -> torch.Tensor:
    """A new (B, N, 3, h, d) tensor: the gradient of the qkv projection."""
    b, h, n, d = q.shape
    return torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)


def _grad_views(dqkv):
    """dq, dk, dv as (B, h, N, d) views of one (B, N, 3, h, d) tensor."""
    return [t.transpose(1, 2) for t in dqkv.unbind(2)]


def attention_dense(q, k, v, scale: float, lse=None) -> torch.Tensor:
    """K1: whole-sequence attention. q, k, v: (B, h, N, d) -> (B, h, N, d);
    on CUDA the result is a view of a (B, N, h, d) tensor, so merging
    heads afterwards costs no copy (the plain version's result is copied
    into the same layout on the CPU, so the operator's fake output holds on
    both devices). With ``lse`` (fp32, B*h*N elements) the kernel also
    writes each row's log-sum-exp of the scaled scores, which K2 needs."""
    if _plain_or_raise(q):
        return _empty_out(q).copy_(attention_plain(q, k, v, scale))
    _check(q, k, v)
    _refuse_grad(q, k, v)
    b, h, n, d = q.shape
    if lse is not None and not (lse.device == q.device and lse.dtype == torch.float32
                                and lse.is_contiguous() and lse.numel() == b * h * n):
        raise ValueError("lse must be a contiguous fp32 tensor of B*h*N elements")
    out = _empty_out(q)
    lib = build.load("attention")
    err = lib.mp_attention_dense(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), KERNEL_DTYPES[q.dtype],
        b, h, n, d, *_strides(q), float(scale), q.device.index, _stream(q),
    )
    build.check(lib, err, "mp_attention_dense")
    LAUNCHES["attention_dense"][q.dtype] += 1
    return out


def attention_packed(q, k, v, scale: float) -> torch.Tensor:
    """K3: per-window attention for N <= 32 (the spatial layout). Same
    contract as :func:`attention_dense`, without the log-sum-exp: its
    backward recomputes each tiny window whole."""
    if _plain_or_raise(q):
        return _empty_out(q).copy_(attention_plain(q, k, v, scale))
    _check(q, k, v, max_n=PACKED_MAX_N)
    _refuse_grad(q, k, v)
    b, h, n, d = q.shape
    out = _empty_out(q)
    lib = build.load("attention")
    err = lib.mp_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        KERNEL_DTYPES[q.dtype], b, h, n, d, *_strides(q), float(scale),
        q.device.index, _stream(q),
    )
    build.check(lib, err, "mp_attention_packed")
    LAUNCHES["attention_packed"][q.dtype] += 1
    return out


def attention_dense_bwd(q, k, v, out, dout, lse, scale: float) -> torch.Tensor:
    """K2: the gradient of K1. q, k, v: (B, h, N, d) views of one qkv
    tensor; out and dout: (B, h, N, d), sharing strides; lse: K1's
    log-sum-exp. Returns the (B, N, 3, h, d) gradient of the qkv tensor."""
    if _plain_or_raise(q):
        return torch.stack(
            [g.transpose(1, 2) for g in attention_plain_bwd(q, k, v, dout, scale)],
            dim=2,
        )
    _check(q, k, v)
    _check_grad_inputs(q, (out, dout), "out and dout")
    b, h, n, d = q.shape
    if not (lse.device == q.device and lse.dtype == torch.float32
            and lse.is_contiguous() and lse.numel() == b * h * n):
        raise ValueError("lse must be K1's contiguous fp32 log-sum-exp")
    dqkv = _empty_dqkv(q)
    dq, dk, dv = _grad_views(dqkv)
    delta = torch.empty_like(lse)
    lib = build.load("attention")
    err = lib.mp_attention_dense_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), KERNEL_DTYPES[q.dtype], b, h, n, d,
        *_strides(q), *_strides(dout), *_strides(dq), float(scale),
        q.device.index, _stream(q),
    )
    build.check(lib, err, "mp_attention_dense_bwd")
    LAUNCHES["attention_dense_bwd"][q.dtype] += 1
    return dqkv


@torch.library.custom_op("manipose::attention_dense", mutates_args=())
def attention_dense_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """:func:`attention_dense` (K1, no log-sum-exp) as an operator."""
    return attention_dense(q, k, v, scale)


@torch.library.custom_op("manipose::attention_packed", mutates_args=())
def attention_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """:func:`attention_packed` (K3) as an operator."""
    return attention_packed(q, k, v, scale)


@attention_dense_op.register_fake
@attention_packed_op.register_fake
def _attention_fake(q, k, v, scale):
    return _empty_out(q)


def attention_packed_bwd(q, k, v, dout, scale: float) -> torch.Tensor:
    """K4: the gradient of K3 (N <= 32), recomputing each window's scores.
    Same contract as :func:`attention_dense_bwd` without out and lse."""
    if _plain_or_raise(q):
        return torch.stack(
            [g.transpose(1, 2) for g in attention_plain_bwd(q, k, v, dout, scale)],
            dim=2,
        )
    _check(q, k, v, max_n=PACKED_MAX_N)
    _check_grad_inputs(q, (dout,), "dout")
    b, h, n, d = q.shape
    dqkv = _empty_dqkv(q)
    dq, dk, dv = _grad_views(dqkv)
    lib = build.load("attention")
    err = lib.mp_attention_packed_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), KERNEL_DTYPES[q.dtype],
        b, h, n, d, *_strides(q), *_strides(dout), *_strides(dq),
        float(scale), q.device.index, _stream(q),
    )
    build.check(lib, err, "mp_attention_packed_bwd")
    LAUNCHES["attention_packed_bwd"][q.dtype] += 1
    return dqkv


def packed_launch_shape(dtype, d: int, n: int, backward: bool, windows: int,
                        device=None) -> dict:
    """How K3 (or K4, ``backward``) launches on a CUDA device for
    ``windows`` windows of ``n`` rows at head dim ``d``: warps a block,
    windows a warp stages (its ring's slots), blocks an SM (from the
    kernel's occupancy), shared bytes a block and blocks of the launch."""
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    shape = (ctypes.c_int * 5)()
    lib = build.load("attention")
    err = lib.mp_attention_packed_shape(KERNEL_DTYPES[dtype], d, n, int(backward),
                                        windows, index, ctypes.addressof(shape))
    build.check(lib, err, "mp_attention_packed_shape")
    return dict(zip(("warps", "slots", "blocks_per_sm", "smem_bytes", "blocks"), shape))


def split_heads(qkv, num_heads: int):
    """(B, N, 3*h*d) -> q, k, v as strided (B, h, N, d) views: the kernels
    read them in place."""
    b, n, c3 = qkv.shape
    qkv = qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads))
    return [t.transpose(1, 2) for t in qkv.unbind(2)]


def merge_heads(out) -> torch.Tensor:
    """(B, h, N, d) -> (B, N, h*d); free for the kernels' (B, N, h, d)
    outputs."""
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


class DenseAttention(torch.autograd.Function):
    """K1 forward (with the log-sum-exp), K2 backward, on the qkv tensor."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        q, k, v = split_heads(qkv, num_heads)
        b, h, n, _ = q.shape
        lse = None
        if qkv.is_cuda:
            lse = torch.empty((b, h, n), dtype=torch.float32, device=qkv.device)
        out = attention_dense(q, k, v, scale, lse=lse)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return merge_heads(out)

    @staticmethod
    def backward(ctx, grad):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = split_heads(qkv, ctx.num_heads)
        dout = grad.contiguous().view(out.transpose(1, 2).shape).transpose(1, 2)
        dqkv = attention_dense_bwd(q, k, v, out, dout, lse, ctx.scale)
        return dqkv.view(qkv.shape), None, None


class PackedAttention(torch.autograd.Function):
    """K3 forward, K4 backward, on the qkv tensor (N <= 32)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        q, k, v = split_heads(qkv, num_heads)
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return merge_heads(attention_packed(q, k, v, scale))

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        q, k, v = split_heads(qkv, ctx.num_heads)
        b, h, n, d = q.shape
        dout = grad.contiguous().view(b, n, h, d).transpose(1, 2)
        dqkv = attention_packed_bwd(q, k, v, dout, ctx.scale)
        return dqkv.view(qkv.shape), None, None


def padded_head_dim(d: int):
    """The head dim of the kernel that runs heads of dim ``d``: the next in
    ``HEAD_DIMS``, or None past the largest."""
    return next((w for w in HEAD_DIMS if w >= d), None)


def attention(qkv, num_heads: int, scale: float) -> torch.Tensor:
    """Multi-head attention on the qkv projection: (B, N, 3*h*d) ->
    (B, N, h*d). N <= 32 (the spatial layout) goes to K3/K4, longer
    sequences (the temporal layout) to K1/K2. A head dim the kernels are
    not built for is zero-padded up to the next built one: zero columns of
    q and k leave q k^T unchanged and zero columns of v give output
    columns that are sliced away (autograd pads dO and slices dq, dk, dv
    back); the scale stays the caller's."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * num_heads)
    dp = padded_head_dim(d)
    if dp is not None and dp != d:
        qkv = F.pad(qkv.reshape(b, n, 3, num_heads, d), (0, dp - d))
        out = attention(qkv.reshape(b, n, 3 * num_heads * dp), num_heads, scale)
        return out.reshape(b, n, num_heads, dp)[..., :d].reshape(b, n, num_heads * d)
    packed = qkv.shape[1] <= PACKED_MAX_N
    if torch.is_grad_enabled() and qkv.requires_grad:
        fn = PackedAttention if packed else DenseAttention
        return fn.apply(qkv, num_heads, scale)
    _plain_or_raise(qkv)  # the operator would run its fake on another device
    kernel = attention_packed_op if packed else attention_dense_op
    return merge_heads(kernel(*split_heads(qkv, num_heads), scale))
