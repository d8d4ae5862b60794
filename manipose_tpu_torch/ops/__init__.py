"""Kernels of the port and their dispatch.

K1 and K3 (``cuda_attention``) and K5 (``cuda_mlp``) are hand-written CUDA
C++ kernels for Hopper (``csrc/``), built by ``build`` at first use. Each
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor, and counts its launches.
"""

from __future__ import annotations

from typing import Dict

from . import cuda_attention, cuda_mlp


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {**cuda_attention.LAUNCHES, **cuda_mlp.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (cuda_attention.LAUNCHES, cuda_mlp.LAUNCHES):
        for name in counts:
            counts[name] = 0
