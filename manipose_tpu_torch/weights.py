"""Carrying weights into the port.

``state_dict_from_jax`` maps the JAX package's flax variables (as numpy
arrays) to the port's state dict, which uses the reference's names; flax
kernels (in, out) become torch weights (out, in), and the K stacked MCL
heads are split per head; the int8 layers of a ``quantize_params`` tree
(``kernel_q`` (in, out) int8 and ``scale``) become ``weight_q`` (out, in)
and ``scale``. ``load_torch_checkpoint`` reads a reference ``.pth`` file.
Either result loads with ``load_state_dict(strict=True)``.
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
        if mod is None:
            return
        if "kernel_q" in mod:  # an int8 layer (ops/quant.py)
            w_q = torch.from_numpy(np.array(mod["kernel_q"], dtype=np.int8))
            sd[f"{prefix}{torch_name}.weight_q"] = w_q.T.contiguous()
            sd[f"{prefix}{torch_name}.scale"] = _t(mod["scale"])
        else:
            sd[f"{prefix}{torch_name}.weight"] = _t(mod["kernel"]).T.contiguous()
        if "bias" in mod:
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


def _numpy_globals():
    """The numpy globals a checkpoint's numpy scalars and arrays unpickle
    through, under the module names of numpy 1 and numpy 2: scalars and
    arrays of the numeric dtypes, nothing else (no object arrays)."""
    core = np._core if hasattr(np, "_core") else np.core
    allowed = [np.dtype, np.ndarray]
    for fn in (core.multiarray.scalar, core.multiarray._reconstruct):
        allowed += [(fn, f"{mod}.multiarray.{fn.__name__}")
                    for mod in ("numpy.core", "numpy._core")]
    numeric = {type(np.dtype(c)) for c in np.typecodes["All"] if c not in "OSUVMm"}
    return allowed + sorted(numeric, key=str)


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` file -> state dict, unwrapping ``model_pos``
    and DataParallel's ``module.`` prefixes. The file is unpickled with
    ``weights_only=True``, allowing besides tensors only numpy's numeric
    scalars and arrays (an epoch counter or a metric saved beside
    ``model_pos``, which the reference's loader accepts); a pickle naming
    any other global is refused."""
    with torch.serialization.safe_globals(_numpy_globals()):
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_dict.get("model_pos"), dict):
        state_dict = state_dict["model_pos"]
    return OrderedDict(
        (re.sub(r"^module\.", "", k), v) for k, v in state_dict.items()
    )
