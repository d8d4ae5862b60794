"""Kernels of the port and their dispatch.

K1 and K3 (``cuda_attention``), K5 (``cuda_mlp``), the DSTformer's
stream fusion (``cuda_fusion``) and the fp32 linear of the trunks' qkv and
proj (``cuda_linear``), and their backward kernels K2, K4, K6, the
fusion's and the linear's, are hand-written CUDA C++ kernels for Hopper
(``csrc/``), built by ``build`` at first use. Each wrapper launches its
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor; the autograd Functions pair each forward kernel with its
backward. K5 and K6 each run on wgmma or on mma.sync, as
``cuda_mlp.takes_wgmma`` picks; the linear runs on wgmma or leaves the
product to the library, as ``cuda_linear.takes_wgmma`` picks.

Every launch counts in one ledger (``launches``) by kernel, path and
operand dtype, read here with :func:`launch_counts`; ``launches.KERNELS``
lists each kernel's paths and the device kernels each one runs.
"""

# noqa: F401 below: the modules register their kernels, in this order
from . import cuda_attention, cuda_mlp, cuda_fusion, cuda_linear  # noqa: F401
from .launches import (by_kernel, graph_replays, launch_counts, launch_snapshot,  # noqa: F401
                       launches_since, record_replay, replayed_counts, reset_launch_counts)
