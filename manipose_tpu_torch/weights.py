"""Carrying weights into the port.

``state_dict_from_jax`` maps the JAX package's flax variables (as numpy
arrays) to the port's state dict, which uses the reference's names; flax
kernels (in, out) become torch weights (out, in), and the K stacked MCL
heads are split per head. ``load_torch_checkpoint`` reads a reference
``.pth`` file. Either result loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _trunk(params: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def linear(flax_name, torch_name, mod=None):
        mod = params.get(flax_name) if mod is None else mod
        if mod is not None:
            sd[f"{prefix}{torch_name}.weight"] = _t(mod["kernel"]).T.contiguous()
            sd[f"{prefix}{torch_name}.bias"] = _t(mod["bias"])

    def layernorm(flax_name, torch_name, mod=None):
        mod = params.get(flax_name) if mod is None else mod
        if mod is not None:
            sd[f"{prefix}{torch_name}.weight"] = _t(mod["scale"])
            sd[f"{prefix}{torch_name}.bias"] = _t(mod["bias"])

    linear("spatial_embed", "Spatial_patch_to_embedding")
    for flax_name, torch_name in (("spatial_pos_embed", "Spatial_pos_embed"),
                                  ("temporal_pos_embed", "Temporal_pos_embed")):
        if flax_name in params:
            sd[f"{prefix}{torch_name}"] = _t(params[flax_name])
    layernorm("spatial_norm", "Spatial_norm")
    layernorm("temporal_norm", "Temporal_norm")
    layernorm("head_norm", "head.0")
    linear("head", "head.1")
    for flax_blocks, torch_blocks in (("ste_block", "STEblocks"),
                                      ("tte_block", "TTEblocks")):
        i = 0
        while f"{flax_blocks}_{i}" in params:
            block = params[f"{flax_blocks}_{i}"]
            bp = f"{torch_blocks}.{i}."
            layernorm(None, bp + "norm1", block["norm1"])
            layernorm(None, bp + "norm2", block["norm2"])
            linear(None, bp + "attn.qkv", block["attn"]["qkv"])
            linear(None, bp + "attn.proj", block["attn"]["proj"])
            linear(None, bp + "mlp.fc1", block["mlp"]["fc1"])
            linear(None, bp + "mlp.fc2", block["mlp"]["fc2"])
            i += 1
    return sd


def _mcl_heads(heads: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for h in range(np.shape(heads["ln_scale"])[0]):
        hp = f"{prefix}head.{h}."
        sd[hp + "norm.weight"] = _t(heads["ln_scale"][h])
        sd[hp + "norm.bias"] = _t(heads["ln_bias"][h])
        sd[hp + "prediction_head.weight"] = _t(heads["pred_kernel"][h]).T.contiguous()
        sd[hp + "prediction_head.bias"] = _t(heads["pred_bias"][h])
        sd[hp + "score_head.weight"] = _t(heads["score_kernel"][h]).T.contiguous()
        sd[hp + "score_head.bias"] = _t(heads["score_bias"][h])
    return sd


def _segments(params: Dict[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    proj = params["joints_to_segments_proj"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    sd[prefix + "joints_to_segments_proj.weight"] = _t(proj["kernel"]).T.contiguous()
    sd[prefix + "joints_to_segments_proj.bias"] = _t(proj["bias"])
    sd.update(_trunk(params["trunk"], prefix))
    return sd


def state_dict_from_jax(variables: Dict, arch: str) -> Dict[str, torch.Tensor]:
    """flax variables (``{"params": ...}`` or the params tree, numpy leaves)
    -> the port's state dict for ``arch`` ("mixste" | "manifold" |
    "rmcl_manifold").

    The map is linear (a transpose, a split of the stacked heads), so it
    carries any tree of the params' structure into the port's names as
    well: a JAX gradient tree, or the params after optimizer steps, for
    comparison with the port's ``.grad`` or parameters."""
    params = variables.get("params", variables)
    if arch == "mixste":
        return _trunk(params, "")
    if arch == "manifold":
        sd = _trunk(params["rotations_module"], "rotations_module.")
    elif arch == "rmcl_manifold":
        rot = params["rotations_module"]
        sd = _trunk(rot["trunk"], "rotations_module.")
        sd.update(_mcl_heads(rot["heads"], "rotations_module."))
    else:
        raise ValueError(f"unknown arch: {arch}")
    sd.update(_segments(params["segments_module"], "segments_module."))
    return sd


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` file -> state dict, unwrapping ``model_pos``
    and DataParallel's ``module.`` prefixes."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_dict.get("model_pos"), dict):
        state_dict = state_dict["model_pos"]
    return OrderedDict(
        (re.sub(r"^module\.", "", k), v) for k, v in state_dict.items()
    )
