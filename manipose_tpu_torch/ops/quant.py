"""int8 weight+activation quantization for serving.

Port of ``manipose_tpu/ops/quant.py``. Only the trunk's hot products
(qkv, proj, fc1 and fc2 of both trunks) are quantized; the embeddings and
heads stay float. The scheme is the JAX package's:

- weights: per-output-channel symmetric int8, scale = max|w_row| / 127,
  folded offline by :func:`quantize_state_dict` (the port stores a weight
  (out, in), as ``nn.Linear`` does, so a row here is a column of the JAX
  kernel);
- activations: dynamic per-row int8, scale = max|x_row| / 127 clamped at
  1e-8, codes round(x / scale) (half to even, as ``jnp.round``) clipped to
  +-127;
- an int8 x int8 -> int32 product, dequantized as
  ``y.float() * a_scale * w_scale + bias`` in fp32, then cast to the
  compute dtype.

The int8 product is ``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM on
the card, an exact int32 product on the CPU): the JAX package leaves it to
XLA (``lax.dot_general(..., preferred_element_type=int32)``), not to a
Pallas kernel. On the card ``_int_mm`` takes only m > 16 rows and k and n
multiples of 8; :func:`int_mm` zero-pads the operands up to that and
slices the result back, which is exact in int32. What it still refuses
raises: nothing gives way to a float product.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

# module paths whose Linear weights get quantized (must match the quant
# wiring in models/mix_ste.py)
QUANT_TARGETS = (
    r"attn\.qkv$",
    r"attn\.proj$",
    r"mlp\.fc1$",
    r"mlp\.fc2$",
)
# what ``torch._int_mm`` takes on the card: m > INT_MM_MIN_ROWS, k and n
# multiples of INT_MM_ALIGN
INT_MM_MIN_ROWS = 16
INT_MM_ALIGN = 8


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device. PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which differs from the
    quotient in the last bit for some t; a 0-dim tensor divisor on the same
    device gets the true division that the CPU and the JAX package do."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def quantize_weight(w: torch.Tensor):
    """fp weight (out, in) -> (int8 weight (out, in), per-row fp32 scale
    (out,)): the formula of ``quantize_kernel`` (``quant.py:82-87``) on the
    transposed layout."""
    w = w.detach().float()
    scale = _div127(torch.clamp(w.abs().amax(dim=1), min=1e-8))
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_rows(x: torch.Tensor):
    """Dynamic symmetric per-row activation quantization: x (..., k) ->
    (int8 codes (..., k), fp32 scale (..., 1))."""
    x32 = x.float()
    a_scale = torch.clamp(_div127(x32.abs().amax(dim=-1, keepdim=True)), min=1e-8)
    x_q = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
    return x_q, a_scale


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 times w (n, k) int8, transposed -> (m, n) int32, by
    ``torch._int_mm`` on the row-major codes and the weight's column-major
    transpose (the layout cuBLASLt's int8 GEMM takes). Shapes it refuses
    on the card are zero-padded: rows up to INT_MM_MIN_ROWS + 1, k and n up
    to multiples of INT_MM_ALIGN; zero columns add nothing to an int32
    sum, and the padded rows and columns are sliced away."""
    m, k = a.shape
    n = w.shape[0]
    pm = max(0, INT_MM_MIN_ROWS + 1 - m)
    pk = -k % INT_MM_ALIGN
    pn = -n % INT_MM_ALIGN
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pk, 0, pn))
    y = torch._int_mm(a, w.t())
    if pm or pn:
        y = y[:m, :n]
    return y


class QuantLinear(nn.Module):
    """int8 weight+activation Linear, the counterpart of ``QuantDense``
    (``quant.py:44-79``): buffers ``weight_q`` (out, in) int8, ``scale``
    (out,) fp32 and ``bias`` (out,) fp32, zeros, ones and zeros until a
    quantized state dict is loaded. The output is in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_q", torch.zeros((out_features, in_features),
                                                     dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q, a_scale = quantize_rows(x)
        y = int_mm(x_q.reshape(-1, self.in_features), self.weight_q)
        y = y.reshape(x.shape[:-1] + (self.out_features,))
        y = y.float() * a_scale * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.compute_dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, compute_dtype={self.compute_dtype}")


def quantize_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float state dict -> the quant model's layout, as
    ``quantize_params`` maps the JAX tree: every Linear at a
    :data:`QUANT_TARGETS` path has its ``weight`` replaced by ``weight_q``
    and ``scale`` (its bias kept, in fp32); every other entry passes
    through, so a quantized state dict maps to itself."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for key, value in state_dict.items():
        path, _, leaf = key.rpartition(".")
        target = any(re.search(p, path) for p in QUANT_TARGETS)
        if target and leaf == "weight":
            out[f"{path}.weight_q"], out[f"{path}.scale"] = quantize_weight(value)
        elif target and leaf == "bias":
            out[key] = value.float()
        else:
            out[key] = value
    return out


def int8_speedup(m: int = 8192, k: int = 512, n: int = 512, iters: int = 20,
                 device="cuda") -> float:
    """Measured bf16/int8 GEMM time ratio at a trunk-like shape on
    ``device``: > 1 means int8 products are faster there.

    On the card it times ``int_mm`` (``torch._int_mm``, cuBLASLt's int8
    tensor-core GEMM) against a bf16 ``torch.matmul`` with CUDA events over
    ``iters`` calls each, after a warm-up of both; on the CPU the two are
    timed on the host clock. ``Predictor(quantize=True)`` serves int8 only
    when the ratio is at least 1.05.

    The data sheet gives the H100 twice the bf16 rate in int8, but the
    trunk's products are bound by bytes, not operations, and ``_int_mm``
    writes an int32 result, twice the bytes of a bf16 one: on an NVIDIA
    H100 80GB HBM3 at 700 W this probe read 0.8738, and the int8 products
    at the flagship's serving shapes took 1.2-1.6x the bf16 ``F.linear``
    time (``chip_smoke.py`` phase 28). So on that card ``quantize=True``
    stays on the float path, and ``quantize="force"`` serves int8.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a8 = torch.randint(-127, 128, (m, k), generator=gen, device=device,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                       dtype=torch.int8)
    ab = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    wb = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)

    def seconds(fn) -> float:
        for _ in range(3):
            fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return time.perf_counter() - t0
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    t8 = seconds(lambda: int_mm(a8, w8))
    tb = seconds(lambda: torch.matmul(ab, wb))
    return tb / t8
