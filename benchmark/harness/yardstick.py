"""The benchmark's yardstick: peaks, each kernel operation's work from its
shapes, and the operations and FLOPs of the MixSTE lineage's trunks, from
which each architecture (``archs/<arch>.py``) counts its model's.

The operations and bytes of K1-K6 are frozen copies of the arithmetic of
``chip_smoke.py``'s ``bound_ms`` and its ``attention_case``,
``attention_bwd_case``, ``mlp_case`` and ``mlp_bwd_case`` (the PyTorch
port's smoke script): each input byte read once, each output byte
written once, whatever the kernel reads again.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates). float32 products
# that keep float32 accuracy on the tensor cores take three TF32 passes,
# so the float32 peak is the TF32 rate over three.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
ELEM = {"float32": 4, "bfloat16": 2}
PACKED_MAX_N = 32  # attention over at most this many tokens runs per window


def bound_s(flops: float, n_bytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations at
    the peak rate and the bytes at the memory's rate."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S)


# operation -> (flops, bytes) from its shape, as chip_smoke.py counts them
def work(op: str, shape: Tuple[int, ...], dtype: str) -> Tuple[float, float]:
    e = ELEM[dtype]
    if op == "attention_dense":  # (batch * heads, N, d)
        bh, n, d = shape
        return 4.0 * bh * n * n * d, 4 * bh * n * d * e
    if op == "attention_dense_bwd":  # q, k, v, out, dout, lse read; dq, dk, dv
        bh, n, d = shape
        return 10.0 * bh * n * n * d, 8 * bh * n * d * e + 4 * bh * n
    if op == "attention_packed":  # (windows * heads, N, d)
        w, n, d = shape
        return 4.0 * w * n * n * d, 4 * w * n * d * e
    if op == "attention_packed_bwd":  # q, k, v, dout read; dq, dk, dv
        w, n, d = shape
        return 10.0 * w * n * n * d, 7 * w * n * d * e
    if op == "fused_mlp":  # (M, C, H): x, w1, b1, w2, b2 read, out written
        m, c, h = shape
        return 4.0 * m * c * h, (2 * m * c + 2 * c * h + h + c) * e
    if op == "fused_mlp_bwd":  # x, g, w1, b1, w2 read; dx, dw1, db1, dw2, db2
        m, c, h = shape
        return 10.0 * m * c * h, (3 * m * c + 4 * c * h + 2 * h + c) * e
    raise ValueError(f"no work formula for operation {op!r}")


def mixste_kernel_ops(trunks: List[dict], seq_len: int, windows: int,
                      backward: bool, ratio: float) -> Dict[Tuple[str, tuple], int]:
    """{(operation, shape): calls} of MixSTE trunks in one forward of
    ``windows`` windows (and its backward): per trunk and layer one spatial
    attention over its ``n`` tokens, one temporal attention (per window
    when L <= 32, else dense) and one fused MLP in each of the spatial and
    temporal blocks. A trunk: ``dict(c=width, heads=, depth=, n=tokens)``."""
    calls: Dict[Tuple[str, tuple], int] = {}

    def add(op, shape, n):
        calls[(op, shape)] = calls.get((op, shape), 0) + n
        if backward:
            calls[(op + "_bwd", shape)] = calls.get((op + "_bwd", shape), 0) + n

    for t in trunks:
        d = t["c"] // t["heads"]
        add("attention_packed", (windows * seq_len * t["heads"], t["n"], d), t["depth"])
        temporal = "attention_packed" if seq_len <= PACKED_MAX_N else "attention_dense"
        add(temporal, (windows * t["n"] * t["heads"], seq_len, d), t["depth"])
        add("fused_mlp", (windows * seq_len * t["n"], t["c"], int(t["c"] * ratio)),
            2 * t["depth"])
    return calls


def mixste_flops(trunks: List[dict], seq_len: int, windows: int, ratio: float) -> float:
    """Matrix-product FLOPs of MixSTE trunks in one forward of ``windows``
    windows: every block's qkv, attention, projection and MLP."""
    total = 0.0
    for t in trunks:
        c, tokens = t["c"], windows * seq_len * t["n"]
        per_block = 2 * tokens * (3 * c * c + c * c + 2 * ratio * c * c)
        attn = 4 * tokens * c * (t["n"] + seq_len)  # a spatial and a temporal block
        total += 2 * t["depth"] * per_block + t["depth"] * attn
    return total


def kernel_classes(kernels_dir: str) -> List[dict]:
    """Every ``kernels/<class>.json``: {"op": operation, "patterns": [device
    kernel name substrings]}, with its file's name as ``class``."""
    out = []
    for path in sorted(glob.glob(os.path.join(kernels_dir, "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        spec["class"] = os.path.basename(path)[:-len(".json")]
        out.append(spec)
    return out


def op_of(name: str, classes: List[dict]):
    """The operation a device kernel implements, by its name, or None."""
    for spec in classes:
        if any(p in name for p in spec["patterns"]):
            return spec["op"]
    return None
