"""Kernels of the port and their dispatch.

K1 and K3 (``cuda_attention``), K5 (``cuda_mlp``) and the DSTformer's
stream fusion (``cuda_fusion``), and their backward kernels K2, K4, K6 and
the fusion's, are hand-written CUDA C++ kernels for Hopper (``csrc/``),
built by ``build`` at first use. Each wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor; the
autograd Functions pair each forward kernel with its backward. K5 and K6
each run on wgmma or on mma.sync, as ``cuda_mlp.takes_wgmma`` picks.

Every launch counts in one ledger (``launches``) by kernel, path and
operand dtype, read here with :func:`launch_counts`; ``launches.KERNELS``
lists each kernel's paths and the device kernels each one runs.
"""

from . import cuda_attention, cuda_mlp, cuda_fusion  # noqa: F401  (they register, in this order)
from .launches import (by_kernel, graph_replays, launch_counts, launch_snapshot,  # noqa: F401
                       launches_since, record_replay, replayed_counts, reset_launch_counts)
