"""Kernels of the port and their dispatch.

K1 and K3 (``cuda_attention``) and K5 (``cuda_mlp``), and their backward
kernels K2, K4 and K6, are hand-written CUDA C++ kernels for Hopper
(``csrc/``), built by ``build`` at first use. Each wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor, and counts its launches by operand dtype; the autograd Functions
pair each forward kernel with its backward.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import cuda_attention, cuda_mlp


def launch_counts(dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel: all of them, or
    only those on ``dtype`` operands (fp32 or bf16)."""
    counts = {**cuda_attention.LAUNCHES, **cuda_mlp.LAUNCHES}
    return {name: sum(by_dtype.values()) if dtype is None else by_dtype[dtype]
            for name, by_dtype in counts.items()}


def reset_launch_counts() -> None:
    for counts in (cuda_attention.LAUNCHES, cuda_mlp.LAUNCHES):
        for by_dtype in counts.values():
            for dtype in by_dtype:
                by_dtype[dtype] = 0
