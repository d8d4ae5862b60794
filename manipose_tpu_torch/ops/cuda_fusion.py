"""The learned stream fusion of MotionBERT's DSTformer: wrappers, plain
PyTorch versions and the autograd Function.

At each depth the DSTformer runs two streams from the same input, x_st
(spatial then temporal) and x_ts (temporal then spatial), and joins them
with a learned softmax over two: (a0, a1) = softmax(W [x_st, x_ts] + b),
x = a0 * x_st + a1 * x_ts, W (2, 2C) and b (2,) the depth's ``ts_attn``
Linear. :func:`stream_fusion` computes it without materialising the
concatenation. On the card it launches the kernels of ``csrc/fusion.cu``
(fp32 only, C a multiple of 4 up to 512; the source says what bounds them
and how they are built); on the CPU it runs :func:`fusion_plain` and
:func:`fusion_plain_bwd`. The JAX package has no DSTformer, so these
kernels replace no TPU kernel.

The forward also writes alpha (R, 2), which the backward reads. Because
the softmax is over two, the logits' gradients are dl0 and -dl0 with
dl0 = a0 a1 (dx.x_st - dx.x_ts), so the backward's dW and db are a row and
its negation. A launch of either direction counts once in ``launches``
(the backward's two kernels together), on fp32 operands.
"""

from __future__ import annotations

import torch

from . import build, launches

ROWS_PER_BLOCK = 8  # one warp a row, 8 warps a block (csrc/fusion.cu)
MAX_CHANNELS = 512
# the grids' largest sizes: the forward 8 blocks of 256 threads an SM of an
# H100's 132, the backward 2 (one wave; its per-block partials are summed
# in block order, so a fixed grid for each R keeps the gradient fixed)
FORWARD_BLOCKS = 132 * 8
BACKWARD_BLOCKS = 132 * 2

# no tensor cores: the kernels are bound by bytes
PATH = "simt"
launches.register("fusion", {
    "stream_fusion": {PATH: ("stream_fusion_kernel",)},
    "stream_fusion_bwd": {PATH: ("stream_fusion_bwd_rows_kernel",
                                 "stream_fusion_bwd_reduce_kernel")},
})


def fusion_plain(x_st, x_ts, weight, bias):
    """-> (a0 x_st + a1 x_ts (R, C), alpha (R, 2)), fp32; the logits
    W [x_st, x_ts] + b as two products, with no concatenation."""
    c = x_st.shape[-1]
    logits = x_st @ weight[:, :c].t() + x_ts @ weight[:, c:].t() + bias
    alpha = torch.softmax(logits, dim=-1)
    return alpha[:, :1] * x_st + alpha[:, 1:] * x_ts, alpha


def fusion_plain_bwd(g, x_st, x_ts, alpha, weight):
    """The gradient of :func:`fusion_plain` for the output gradient g, as
    the kernel takes it: da_k = g.x_k a row, dl0 = a0 a1 (da0 - da1) = -dl1,
    dx_st = a0 g + dl0 (W0 - W1)[:C], dx_ts = a1 g + dl0 (W0 - W1)[C:],
    dW = (r, -r) with r = dl0^T [x_st, x_ts], db = (s, -s) with s = sum(dl0).
    No autograd. -> (dx_st, dx_ts, dW, db)."""
    c = x_st.shape[-1]
    a0, a1 = alpha[:, :1], alpha[:, 1:]
    dl0 = a0 * a1 * ((g * x_st).sum(-1, keepdim=True) - (g * x_ts).sum(-1, keepdim=True))
    wd = weight[0] - weight[1]
    dx_st = a0 * g + dl0 * wd[:c]
    dx_ts = a1 * g + dl0 * wd[c:]
    row = torch.cat([dl0[:, 0] @ x_st, dl0[:, 0] @ x_ts])
    db = dl0.sum()
    return dx_st, dx_ts, torch.stack([row, -row]), torch.stack([db, -db])


def grid_blocks(rows: int, cap: int) -> int:
    """The blocks a launch over ``rows`` rows takes: one warp a row, at most
    ``cap`` blocks walking the rest."""
    return max(1, min(-(-rows // ROWS_PER_BLOCK), cap))


def _check(*ts) -> None:
    x = ts[0]
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("all fusion operands must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the fusion kernels take fp32")
    if not all(t.is_contiguous() for t in ts) or any(t.data_ptr() % 16 for t in ts):
        raise ValueError("fusion operands must be contiguous and 16-byte aligned")
    if x.dim() != 2:
        raise ValueError("x_st must be (R, C)")
    c = x.shape[1]
    if c % 4 or not 4 <= c <= MAX_CHANNELS:
        raise ValueError(f"the fusion kernels take C a multiple of 4 up to {MAX_CHANNELS}, "
                         f"got {c}")


def _plain_or_raise(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no fusion kernel for device {x.device}")
    return False


def fusion_forward(x_st, x_ts, weight, bias):
    """The forward kernel: -> (x (R, C), alpha (R, 2)). Not differentiable
    on the card: :func:`stream_fusion` is."""
    if _plain_or_raise(x_st):
        return fusion_plain(x_st, x_ts, weight, bias)
    _check(x_st, x_ts, weight, bias)
    r, c = x_st.shape
    if x_ts.shape != (r, c) or weight.shape != (2, 2 * c) or bias.shape != (2,):
        raise ValueError(f"need x_ts ({r}, {c}), W (2, {2 * c}), b (2,)")
    out = torch.empty_like(x_st)
    alpha = torch.empty((r, 2), dtype=torch.float32, device=x_st.device)
    lib = build.load("fusion")
    err = lib.mp_stream_fusion(x_st.data_ptr(), x_ts.data_ptr(), weight.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), alpha.data_ptr(), r, c,
                               grid_blocks(r, FORWARD_BLOCKS), x_st.device.index,
                               torch.cuda.current_stream(x_st.device).cuda_stream)
    build.check(lib, err, "mp_stream_fusion")
    launches.count("stream_fusion", PATH, torch.float32)
    return out, alpha


def fusion_backward(g, x_st, x_ts, alpha, weight):
    """The backward kernels: -> (dx_st, dx_ts, dW, db)."""
    if _plain_or_raise(x_st):
        return fusion_plain_bwd(g, x_st, x_ts, alpha, weight)
    _check(x_st, x_ts, g, alpha, weight)
    r, c = x_st.shape
    if g.shape != (r, c) or x_ts.shape != (r, c) or alpha.shape != (r, 2) \
            or weight.shape != (2, 2 * c):
        raise ValueError(f"need g and x_ts ({r}, {c}), alpha ({r}, 2), W (2, {2 * c})")
    blocks = grid_blocks(r, BACKWARD_BLOCKS)
    dx_st, dx_ts = torch.empty_like(x_st), torch.empty_like(x_ts)
    dw = torch.empty_like(weight)
    db = torch.empty(2, dtype=torch.float32, device=x_st.device)
    part = torch.empty((blocks, 2 * c + 1), dtype=torch.float32, device=x_st.device)
    lib = build.load("fusion")
    err = lib.mp_stream_fusion_bwd(g.data_ptr(), x_st.data_ptr(), x_ts.data_ptr(),
                                   alpha.data_ptr(), weight.data_ptr(), dx_st.data_ptr(),
                                   dx_ts.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                   part.data_ptr(), r, c, blocks, x_st.device.index,
                                   torch.cuda.current_stream(x_st.device).cuda_stream)
    build.check(lib, err, "mp_stream_fusion_bwd")
    launches.count("stream_fusion_bwd", PATH, torch.float32)
    return dx_st, dx_ts, dw, db


class StreamFusion(torch.autograd.Function):
    """The fusion forward, its backward kernels backward; saves x_st, x_ts,
    alpha and W."""

    @staticmethod
    def forward(ctx, x_st, x_ts, weight, bias):
        out, alpha = fusion_forward(x_st, x_ts, weight, bias)
        ctx.save_for_backward(x_st, x_ts, alpha, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        return fusion_backward(g.contiguous(), *ctx.saved_tensors)


def stream_fusion(x_st, x_ts, weight, bias) -> torch.Tensor:
    """(R, C) streams -> a0 x_st + a1 x_ts, (R, C), differentiable."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_st, x_ts, weight, bias)):
        return StreamFusion.apply(x_st, x_ts, weight, bias)
    return fusion_forward(x_st, x_ts, weight, bias)[0]
