"""Fused MLP kernel K5: wrapper, plain PyTorch version and launch counter.

``fused_mlp`` replaces ``manipose_tpu/ops/pallas_mlp.py::fused_mlp``:
gelu_exact(x W1^T + b1) W2^T + b2 with fp32 accumulation and the (M, H)
intermediate kept on chip; the kernel is in ``csrc/mlp.cu``. Weights are in
torch ``nn.Linear`` layout: w1 (H, C), w2 (C, H).

A CPU tensor takes the plain version, a CUDA tensor launches the kernel
(or the call raises).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHANNELS = (64, 128, 256, 512)
HIDDEN_TILE = 64

# launches of the kernel; reset by ``ops.reset_launch_counts``
LAUNCHES = {"fused_mlp": 0}


def mlp_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """x: (M, C) -> (M, C), fp32 accumulation. Under bf16 the GELU output
    is rounded to bf16 before fc2, as the kernel (and pallas_mlp.py:86)
    does."""
    a = F.linear(x.float(), w1.float(), b1.float())
    h = F.gelu(a).to(x.dtype).float()
    return F.linear(h, w2.float(), b2.float()).to(x.dtype)


def _check(x, w1, b1, w2, b2) -> None:
    ts = (x, w1, b1, w2, b2)
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
            or b1.shape != (h,) or b2.shape != (c,):
        raise ValueError(
            f"need w1 (H, {c}), b1 (H,), w2 ({c}, H), b2 ({c},) with H a "
            f"multiple of {HIDDEN_TILE}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("MLP operands must be contiguous")
    if any(t.data_ptr() % (4 * t.element_size()) for t in ts):
        raise ValueError("MLP operands must start on a 4-element boundary")


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """K5: x (M, C) -> gelu(x w1^T + b1) w2^T + b2, (M, C)."""
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no MLP kernel for device {x.device}")
    _check(x, w1, b1, w2, b2)
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
    LAUNCHES["fused_mlp"] += 1
    return out
