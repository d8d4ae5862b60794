"""Model factory of the port.

Port of ``manipose_tpu/drivers/common.py::instantiate_model`` for the
three architectures. Without weights the model gets torch's default
initialization drawn from a ``torch.Generator`` seeded by
``cfg.run.seed``, so one seed gives the same weights on every machine.
``model.dtype`` (``float32`` or ``bfloat16``) is the compute dtype; the
parameters are fp32 under both, so the init and the weight maps do not
depend on it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import Config
from ..geometry.skeleton import Skeleton
from ..models import (
    ManifoldConfig,
    ManifoldMixSTE,
    MixSTE,
    MixSTEConfig,
    RMCLManifoldMixSTE,
)

# (config key, value the port implements) for settings the port does not
# carry yet; the JAX kernel knobs attn_impl / mlp_impl need no entry: on the
# card every attention and MLP runs the port's kernels
_UNPORTED = (
    ("layout", "fold"),
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(m: Config) -> torch.dtype:
    """``model.dtype`` as a torch dtype (the activations' type)."""
    name = m.get("dtype", "float32")
    if name not in _DTYPES:
        raise ValueError(f"model.dtype={name} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _check_supported(m: Config) -> None:
    if m.get("attn_impl", "xla") == "ring":
        raise NotImplementedError(
            "model.attn_impl=ring (sequence-parallel attention) is not "
            "ported yet"
        )
    for key, supported in _UNPORTED:
        if m.get(key, supported) != supported:
            raise NotImplementedError(
                f"model.{key}={m.get(key)} is not ported yet (only "
                f"{supported})"
            )


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


def instantiate_model(cfg: Config, skeleton: Skeleton):
    """Model factory. Returns (module on the CPU, is_rmcl)."""
    m = cfg.model
    _check_supported(m)
    dtype = compute_dtype(m)
    if m.arch == "mixste":
        model = MixSTE(
            MixSTEConfig(
                num_frame=cfg.data.seq_len,
                num_joints=skeleton.num_joints,
                in_chans=2,
                out_dim=3,
                num_heads=m.nheads,
                depth=m.layers,
                embed_dim=m.channels,
                drop_path_rate=m.drop_path_rate,
                mup=m.mup,
                dtype=dtype,
            )
        )
        rmcl = False
    else:
        manifold_cfg = ManifoldConfig(
            num_frame=cfg.data.seq_len,
            num_joints=skeleton.num_joints,
            num_bones=skeleton.num_bones,
            in_chans=2,
            rot_rep_dim=m.rot_dim,
            num_heads_rot=m.nheads,
            depth_rot=m.layers,
            embed_dim_rot=m.channels,
            num_heads_seg=m.nheads_seg,
            depth_seg=m.layers_seg,
            embed_dim_seg=m.channels_seg,
            drop_path_rate=m.drop_path_rate,
            n_hyp=cfg.multi_hyp.n_hyp,
            mup=m.mup,
            dtype=dtype,
        )
        if m.arch == "manifold":
            model, rmcl = ManifoldMixSTE(manifold_cfg, skeleton), False
        elif m.arch == "rmcl_manifold":
            model, rmcl = RMCLManifoldMixSTE(manifold_cfg, skeleton), True
        else:
            raise ValueError(
                "Only MixSTE, Manifold-MixSTE and RMCL-Manifold-MixSTE "
                f"implemented for now. Got option {m.arch}."
            )
    return torch_default_init(model, cfg.run.seed), rmcl
