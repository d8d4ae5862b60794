"""ManiPose in PyTorch for one NVIDIA H100: the port of ``manipose_tpu``.

The JAX package stays the reference; this package imports nothing of it
(nor JAX). It mirrors its module names:

- ``config``    : the same ``configs/*.yaml`` and override syntax;
- ``geometry``  : skeletons, SO(3) representations, level-parallel FK;
- ``models``    : MixSTE, the manifold model and the rMCL model, with the
                  reference's state-dict names;
- ``ops``       : hand-written CUDA kernels for the trunk's attention (K1,
                  K3) and fused MLP (K5), each beside its plain PyTorch
                  version;
- ``serving``   : ``Predictor``, video windowing and batched inference.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
