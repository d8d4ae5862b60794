"""Weights drawn on the device from the seed.

An architecture (``archs/<arch>.py``) works out its parameter set from
the configuration file's sizes under the reference implementation's
state-dict names, which the program loads strictly, and draws it here:
one normal draw of every value, from a ``torch.Generator`` on the card,
cut into the leaves and scaled: Linear weights by 1/sqrt(fan_in), biases
and positional tables by 0.02, LayerNorms about (1, 0) by 0.05. The
architecture then gives its heads the scales a trained model's have.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

Shape = Tuple[int, ...]


def mixste_trunk(pre: str, c: int, depth: int, tokens: int, frames: int,
                 ratio: float) -> List[Tuple[str, Shape]]:
    """(name, shape) of a MixSTE trunk's parameters under the prefix ``pre``."""
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


def draw(spec: List[Tuple[str, Shape]], seed: int, device, is_norm: Callable[[str], bool],
         head: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
         ) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` for ``seed``, on ``device``, as a state dict.
    ``is_norm(name)``: a LayerNorm's leaf; ``head(name, value)``: the
    architecture's rescaling of a leaf after the common scales."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [int(torch.Size(s).numel()) for _, s in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(spec, torch.split(flat, sizes)):
        v = part.view(shape)
        if is_norm(name):
            v = (1.0 if name.endswith("weight") else 0.0) + 0.05 * v
        elif name.endswith("weight"):
            v = v / shape[1] ** 0.5
        else:
            v = 0.02 * v
        if head is not None:
            v = head(name, v)
        out[name] = v.contiguous()
    return out
