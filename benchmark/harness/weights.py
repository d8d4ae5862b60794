"""Weights of the rMCL model drawn on the device from the seed.

The parameter set is worked out from the configuration file's sizes under
the reference implementation's state-dict names, which the program loads
strictly. One normal draw of every value, from a ``torch.Generator`` on
the card, is cut into the leaves and scaled: Linear weights by
1/sqrt(fan_in), biases and positional tables by 0.02, LayerNorms about
(1, 0) by 0.05. The heads read out as a trained model's do: the rotation
heads about the identity rotation (bias) with a spread of a quarter of
the rest's (weights), the segments head about a bone length of 0.25 m
with a tenth, so that the poses are those of a body and the 6D vectors
are far from degenerate.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]


def _trunk(pre: str, c: int, depth: int, tokens: int, frames: int,
           ratio: float) -> List[Tuple[str, Shape]]:
    out = [(pre + "Spatial_pos_embed", (1, tokens, c)),
           (pre + "Temporal_pos_embed", (1, frames, c))]
    h = int(c * ratio)
    for kind in ("STEblocks", "TTEblocks"):
        for i in range(depth):
            b = f"{pre}{kind}.{i}."
            out += [(b + "norm1.weight", (c,)), (b + "norm1.bias", (c,)),
                    (b + "attn.qkv.weight", (3 * c, c)), (b + "attn.qkv.bias", (3 * c,)),
                    (b + "attn.proj.weight", (c, c)), (b + "attn.proj.bias", (c,)),
                    (b + "norm2.weight", (c,)), (b + "norm2.bias", (c,)),
                    (b + "mlp.fc1.weight", (h, c)), (b + "mlp.fc1.bias", (h,)),
                    (b + "mlp.fc2.weight", (c, h)), (b + "mlp.fc2.bias", (c,))]
    for norm in ("Spatial_norm", "Temporal_norm"):
        out += [(pre + norm + ".weight", (c,)), (pre + norm + ".bias", (c,))]
    return out


def shapes(cfg: dict) -> List[Tuple[str, Shape]]:
    """(name, shape) of every parameter of the rMCL manifold model."""
    m = cfg["model"]
    joints = len(cfg["skeleton"]["parents"])
    bones, frames = joints - 1, cfg["data"]["seq_len"]
    c, cs, ratio = m["channels"], m["channels_seg"], m.get("mlp_ratio", 2.0)
    rot = "rotations_module."
    out = [(rot + "Spatial_patch_to_embedding.weight", (c, 2)),
           (rot + "Spatial_patch_to_embedding.bias", (c,))]
    out += _trunk(rot, c, m["layers"], joints, frames, ratio)
    for h in range(cfg["multi_hyp"]["n_hyp"]):
        p = f"{rot}head.{h}."
        out += [(p + "norm.weight", (c,)), (p + "norm.bias", (c,)),
                (p + "prediction_head.weight", (m["rot_dim"] + 1, c)),
                (p + "prediction_head.bias", (m["rot_dim"] + 1,)),
                (p + "score_head.weight", (1, joints)), (p + "score_head.bias", (1,))]
    seg = "segments_module."
    out += _trunk(seg, cs, m["layers_seg"], bones, frames, ratio)
    out += [(seg + "head.0.weight", (cs,)), (seg + "head.0.bias", (cs,)),
            (seg + "head.1.weight", (1, cs)), (seg + "head.1.bias", (1,)),
            (seg + "joints_to_segments_proj.weight", (bones * cs, joints * 2)),
            (seg + "joints_to_segments_proj.bias", (bones * cs,))]
    return out


def _is_norm(name: str) -> bool:
    return "norm" in name or name.startswith("segments_module.head.0.")


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights for ``seed``, on ``device``, as a state dict."""
    spec = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [int(torch.Size(s).numel()) for _, s in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    rot_dim = cfg["model"]["rot_dim"]
    identity = torch.zeros(rot_dim + 1, device=device)
    identity[0] = identity[4] = 1.0
    out = {}
    for (name, shape), part in zip(spec, torch.split(flat, sizes)):
        v = part.view(shape)
        if _is_norm(name):
            v = (1.0 if name.endswith("weight") else 0.0) + 0.05 * v
        elif name.endswith("weight"):
            v = v / shape[1] ** 0.5
        else:
            v = 0.02 * v
        if name.endswith("prediction_head.bias"):
            v = v + identity
        elif name.endswith("prediction_head.weight"):
            v = 0.25 * v
        elif name == "segments_module.head.1.bias":
            v = v + 0.25
        elif name == "segments_module.head.1.weight":
            v = 0.1 * v
        out[name] = v.contiguous()
    return out
