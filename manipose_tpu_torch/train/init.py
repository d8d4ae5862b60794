"""Weight-init schemes (``model.init``).

Port of ``manipose_tpu/train/init.py`` and of the initializers the JAX
package's flax modules declare. Flax and torch default to different
Linear initializations, so from-scratch training starts from another
distribution under each, and the JAX package's trajectories under the two
"differ systematically at short horizons":

- ``flax`` (the default, ``model.init`` unset): lecun-normal kernels, a
  normal truncated at two standard deviations and rescaled to a standard
  deviation of 1/sqrt(fan_in) (``models/mix_ste.py:105-110``,
  ``models/rmcl.py:50-59``); zero biases and positional tables;
  LayerNorms at ones and zeros. Fan-in is flax's ``variance_scaling``
  reckoning for the JAX parameter's shape: ``in_features`` for a Dense
  kernel (in, out), but h * c for the stacked MCL ``pred_kernel`` (h, c,
  d) and ``score_kernel`` (h, j, 1), whose leading stack axis counts as a
  receptive field. The port keeps one Linear per head, so each of those
  draws with fan-in n_hyp * in_features.
- ``torch``: torch's default Linear init, weight and bias U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) with fan_in = ``in_features``; what the reference trains
  from.

Both draw from a ``torch.Generator`` seeded with ``run.seed``, module by
module in ``model.modules()`` order, so one seed gives the same weights on
every machine. The draws cannot equal the JAX package's (another RNG); the
distribution does.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from ..models.rmcl import MCLHeads

# a unit normal truncated to [-2, 2] has this standard deviation; flax
# divides by it so that the truncated draw has the one asked for
_TRUNC_STD = 0.87962566103423978


def _truncated_normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """``w`` drawn from a normal of deviation ``std`` truncated at 2 of
    them, as ``jax.random.truncated_normal`` draws it: uniform between the
    normal's CDF at -2 and 2, mapped back through the inverse CDF. (torch's
    own ``trunc_normal_`` changed its algorithm between releases, so one
    seed would give other weights under another torch.)"""
    lo = math.erf(-2.0 / math.sqrt(2.0))  # 2 * CDF(-2) - 1
    w.uniform_(lo, -lo, generator=gen)
    w.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)


def _linear_fan_ins(model: nn.Module) -> dict:
    """{Linear: the fan-in flax reckons for its JAX kernel}: the Linears of
    each head of an ``MCLHeads`` stack count its n_hyp heads."""
    stack = {}
    for mod in model.modules():
        if isinstance(mod, MCLHeads):
            for head in mod:
                for lin in head.modules():
                    if isinstance(lin, nn.Linear):
                        stack[lin] = len(mod)
    return {mod: mod.in_features * stack.get(mod, 1)
            for mod in model.modules() if isinstance(mod, nn.Linear)}


def flax_default_init(model: nn.Module, seed: int) -> nn.Module:
    """Redraw ``model`` as flax's default init does (see the module
    docstring) from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    fan_ins = _linear_fan_ins(model)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                _truncated_normal_(mod.weight, 1.0 / math.sqrt(fan_ins[mod]) / _TRUNC_STD,
                                   gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("_pos_embed"):
                p.zero_()
    return model


def torch_default_init(model: nn.Module, seed: int) -> nn.Module:
    """Redraw every Linear layer as torch's default init does
    (weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))) from a generator
    seeded with ``seed``; LayerNorms keep ones/zeros and the positional
    tables zeros, as in the reference."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                mod.weight.uniform_(-bound, bound, generator=gen)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=gen)
    return model


def init_from_config(model: nn.Module, cfg) -> nn.Module:
    """``model`` drawn from ``cfg.run.seed`` by torch's init when
    ``model.init=torch``, else by flax's (the default), as
    ``manipose_tpu/drivers/common.py:109-118`` picks."""
    if cfg.model.get("init", "flax") == "torch":
        return torch_default_init(model, cfg.run.seed)
    return flax_default_init(model, cfg.run.seed)


# the flax scope path of each Linear of a MixSTE trunk (the port's names,
# ``weights._trunk``'s map read backwards)
_MIXSTE_PATHS = (
    (r"Spatial_patch_to_embedding", ("spatial_embed",)),
    (r"head\.1", ("head",)),
    (r"(STE|TTE)blocks\.(\d+)\.(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)", None),
)


def _mixste_path(name: str):
    """The flax scope path of the Linear ``name`` of a MixSTE trunk."""
    for pattern, path in _MIXSTE_PATHS:
        m = re.fullmatch(pattern, name)
        if m and path is not None:
            return path
        if m:
            kind, i, sub = m.groups()
            return (f"{kind.lower()}_block_{i}", *sub.split("."))
    raise ValueError(f"no flax path for {name!r}: flax_init_from_key takes a MixSTE trunk")


def flax_init_from_key(model: nn.Module, seed: int) -> nn.Module:
    """A MixSTE trunk drawn as the JAX package's ``model.init(
    jax.random.PRNGKey(seed), x)`` draws it: each kernel from flax's key for
    its module path (``utils.jax_random.flax_param_key``) by lecun-normal's
    truncated normal, biases and positional tables zero, LayerNorms ones
    and zeros. The values are the JAX init's within float32 rounding, so a
    port tool starts from its JAX counterpart's weights for one seed."""
    from ..utils import jax_random

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.in_features
                std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / np.float32(_TRUNC_STD)
                key = jax_random.flax_param_key(seed, _mixste_path(name))
                kernel = jax_random.truncated_normal(key, -2.0, 2.0, (fan_in, mod.out_features))
                mod.weight.copy_(torch.from_numpy((kernel * std).T.copy()))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("_pos_embed"):
                p.zero_()
    return model
