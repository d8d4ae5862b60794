"""muP (Maximal Update Parametrization) optimizer support.

Port of ``manipose_tpu/train/mup.py:39-107``, on the port's
reference-named parameters. The reference uses ``mup.MuAdam`` with base
shapes from a channels=64 model; the same width rules apply here:

- hidden matrix-like weights, whose fan-in and fan-out both grow with the
  embedding width (``attn.qkv``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``),
  and the temporal positional table (``Temporal_pos_embed``: under the
  reference's width-and-sequence base shapes it has two infinite
  dimensions) train with lr / width_mult;
- everything else keeps the base lr: biases, LayerNorms, the spatial
  table, weights with a fixed fan-in (patch embeddings, the joints to
  segments projection, the score heads) and the readouts (the trunk's
  head and the MCL ``prediction_head``s, whose width correction is the
  forward's input division, ``mix_ste.py`` and ``rmcl.py``).

The JAX optimizer is optax's chain clip -> add_decayed_weights ->
scale_by_adam -> scale_by_mup -> scale(-lr): the coupled decay sits inside
Adam and the muP scale multiplies the whole update, so torch Adam with
lr * scale per parameter group is the same update.
"""

from __future__ import annotations

import re
from typing import Dict

from torch import nn

from .optim import Optimizer

# parameter names whose learning rate scales as 1/width_mult
_MATRIX_LIKE = (
    r"attn\.qkv\.weight$",
    r"attn\.proj\.weight$",
    r"mlp\.fc1\.weight$",
    r"mlp\.fc2\.weight$",
    r"Temporal_pos_embed$",
)


def _is_matrix_like(name: str) -> bool:
    return any(re.search(p, name) for p in _MATRIX_LIKE)


def mup_lr_scales(model: nn.Module, width_mult: float) -> Dict[str, float]:
    """{parameter name: its learning-rate multiplier}."""
    return {name: (1.0 / width_mult) if _is_matrix_like(name) else 1.0
            for name, _ in model.named_parameters()}


def make_mup_optimizer(
    model: nn.Module,
    width: int,
    base_width: int = 64,
    weight_decay: float = 1e-6,
    grad_clip: float = 0.0,
    skip_nonfinite: bool = False,
) -> Optimizer:
    """MuAdam semantics: torch-coupled weight decay and Adam with each
    parameter's learning rate scaled by :func:`mup_lr_scales`; the global
    learning rate is given at every step, and ``grad_clip`` and
    ``skip_nonfinite`` act as in :class:`~.optim.Optimizer`."""
    scales = mup_lr_scales(model, width / base_width)
    names, params = zip(*model.named_parameters())
    return Optimizer(params, weight_decay=weight_decay, grad_clip=grad_clip,
                     skip_nonfinite=skip_nonfinite,
                     lr_scales=[scales[n] for n in names])
