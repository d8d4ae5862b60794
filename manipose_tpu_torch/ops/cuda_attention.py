"""Attention kernels K1 (dense) and K3 (per-window, tiny N): wrappers,
plain PyTorch versions and launch counters.

``attention_dense`` replaces ``manipose_tpu/ops/pallas_attention.py::
flash_attention`` (temporal layout, N = 243 frames) and
``attention_packed`` replaces ``flash_attention_packed`` (spatial layout,
N = 16 bones or 17 joints). Both compute softmax(scale * Q K^T) V per
(batch, head) with fp32 accumulation; the kernels are in
``csrc/attention.cu``.

Dispatch depends on the device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or the call raises). The plain
versions double as the reference that the kernels are held against.
"""

from __future__ import annotations

import torch

from . import build

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64)  # 8 is model=small's (64 channels, 8 heads)
PACKED_MAX_N = 32

# launches per kernel; reset by ``ops.reset_launch_counts``
LAUNCHES = {"attention_dense": 0, "attention_packed": 0}


def attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v in fp32, cast back to q's dtype.
    q, k, v: (B, h, N, d) -> (B, h, N, d)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


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
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share strides (views of one qkv)")
    if q.stride(3) != 1 or any(s % 4 for s in q.stride()[:3]):
        raise ValueError("q/k/v rows must be contiguous and 4-element aligned")
    for t in (q, k, v):
        if t.data_ptr() % (4 * q.element_size()):
            raise ValueError("q/k/v must start on a 4-element boundary")


def _launch(entry: str, q, k, v, scale: float) -> torch.Tensor:
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lib = build.load("attention")
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        KERNEL_DTYPES[q.dtype], b, h, n, d,
        q.stride(0), q.stride(1), q.stride(2), float(scale),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, entry)
    return out.transpose(1, 2)  # (B, h, N, d) view of (B, N, h, d)


def _plain_or_raise(q) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return False


def attention_dense(q, k, v, scale: float) -> torch.Tensor:
    """K1: whole-sequence attention. q, k, v: (B, h, N, d) -> (B, h, N, d);
    on CUDA the result is a view of a (B, N, h, d) tensor, so merging
    heads afterwards costs no copy."""
    if _plain_or_raise(q):
        return attention_plain(q, k, v, scale)
    _check(q, k, v)
    out = _launch("mp_attention_dense", q, k, v, scale)
    LAUNCHES["attention_dense"] += 1
    return out


def attention_packed(q, k, v, scale: float) -> torch.Tensor:
    """K3: per-window attention for N <= 32 (the spatial layout). Same
    contract as :func:`attention_dense`."""
    if _plain_or_raise(q):
        return attention_plain(q, k, v, scale)
    _check(q, k, v, max_n=PACKED_MAX_N)
    out = _launch("mp_attention_packed", q, k, v, scale)
    LAUNCHES["attention_packed"] += 1
    return out
