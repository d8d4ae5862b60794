"""A plain PyTorch reference of MotionBERT's DSTformer, its fine-tuning loss
and AdamW, for the tests of ``manipose_tpu_torch.models.dstformer``.

Written from the published description (Zhu et al., ICCV 2023, arXiv
2210.06551; ``lib/model/DSTformer.py``, ``lib/model/loss.py`` and
``configs/pose3d/MB_ft_h36m.yaml`` of the MotionBERT repository), in fp32,
on a plain dict of parameters under MotionBERT's state-dict names. It
imports nothing of the port and no JAX. Where the port refolds the stream
for temporal attention, this reference splits the heads as MotionBERT's
``forward_temporal`` does, (B*F, J, 3C) -> (B, H, J, F, d).

- ``shapes(sizes)`` and ``draw(sizes, seed)``: the parameters, drawn from
  a seed (Linear weights with deviation 1/sqrt(fan_in), biases and tables
  0.02, LayerNorms about (1, 0) by 0.05; each ``ts_attn`` weight half a
  Linear's, which spreads the fusion's alphas well away from the published
  initialisation's 1/2 without saturating the softmax);
- ``forward(p, sizes, x)``: (B, F, J, 3 or 2) -> (B, F, J, 3), and
  ``fusion_weights``, the fusions' alphas of one forward;
- ``lift(p, sizes, windows, skeleton)``: the served poses with flip TTA;
- ``loss_terms(pred, target)``: MPJPE, 0.5 N-MPJPE, 20 velocity;
- ``AdamW``: torch's AdamW written out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# the sizes MotionBERT fine-tunes on H36M with (MB_ft_h36m.yaml)
PUBLISHED = dict(dim_in=3, dim_feat=512, dim_rep=512, depth=5, num_heads=8, mlp_ratio=2,
                 num_joints=17, maxlen=243)
EPS = 1e-6  # every LayerNorm (MotionBERT's partial(nn.LayerNorm, eps=1e-6))
FUSION_SPREAD = 0.5


def shapes(s: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    c, h = s["dim_feat"], int(s["dim_feat"] * s["mlp_ratio"])
    out = [("joints_embed.weight", (c, s["dim_in"])), ("joints_embed.bias", (c,)),
           ("pos_embed", (1, s["num_joints"], c)), ("temp_embed", (1, s["maxlen"], 1, c))]
    for stream in ("blocks_st", "blocks_ts"):
        for i in range(s["depth"]):
            b = f"{stream}.{i}."
            for kind in ("s", "t"):
                out += [(f"{b}norm1_{kind}.weight", (c,)), (f"{b}norm1_{kind}.bias", (c,)),
                        (f"{b}norm2_{kind}.weight", (c,)), (f"{b}norm2_{kind}.bias", (c,)),
                        (f"{b}attn_{kind}.qkv.weight", (3 * c, c)),
                        (f"{b}attn_{kind}.qkv.bias", (3 * c,)),
                        (f"{b}attn_{kind}.proj.weight", (c, c)),
                        (f"{b}attn_{kind}.proj.bias", (c,)),
                        (f"{b}mlp_{kind}.fc1.weight", (h, c)), (f"{b}mlp_{kind}.fc1.bias", (h,)),
                        (f"{b}mlp_{kind}.fc2.weight", (c, h)), (f"{b}mlp_{kind}.fc2.bias", (c,))]
    for i in range(s["depth"]):
        out += [(f"ts_attn.{i}.weight", (2, 2 * c)), (f"ts_attn.{i}.bias", (2,))]
    out += [("norm.weight", (c,)), ("norm.bias", (c,)),
            ("pre_logits.fc.weight", (s["dim_rep"], c)), ("pre_logits.fc.bias", (s["dim_rep"],)),
            ("head.weight", (3, s["dim_rep"])), ("head.bias", (3,))]
    return out


def draw(s: dict, seed: int) -> Params:
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for name, shape in shapes(s):
        v = torch.randn(shape, generator=gen)
        if "norm" in name:
            v = (1.0 if name.endswith("weight") else 0.0) + 0.05 * v
        elif name.endswith("weight"):
            v = v / math.sqrt(shape[1])
            if name.startswith("ts_attn."):
                v = FUSION_SPREAD * v
        else:
            v = 0.02 * v
        out[name] = v
    return out


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], EPS)


def _attention(p: Params, name: str, x: torch.Tensor, heads: int, frames: int,
               temporal: bool) -> torch.Tensor:
    """MotionBERT's Attention on (B*F, J, C), spatial over J or temporal
    over the F frames of each joint."""
    bf, j, c = x.shape
    d = c // heads
    qkv = _linear(p, name + ".qkv", x).reshape(bf, j, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B*F, H, J, d)
    if temporal:
        q, k, v = (t.reshape(-1, frames, heads, j, d).permute(0, 2, 3, 1, 4) for t in (q, k, v))
    attn = torch.softmax((q @ k.transpose(-2, -1)) * d**-0.5, dim=-1)
    out = attn @ v
    if temporal:  # (B, H, J, F, d) -> (B, F, J, H, d)
        out = out.permute(0, 3, 2, 1, 4).reshape(bf, j, c)
    else:  # (B*F, H, J, d) -> (B*F, J, H, d)
        out = out.transpose(1, 2).reshape(bf, j, c)
    return _linear(p, name + ".proj", out)


def _block(p: Params, name: str, x: torch.Tensor, s: dict, frames: int,
           order: str) -> torch.Tensor:
    for kind in order:
        x = x + _attention(p, f"{name}.attn_{kind}", _norm(p, f"{name}.norm1_{kind}", x),
                           s["num_heads"], frames, kind == "t")
        h = _linear(p, f"{name}.mlp_{kind}.fc1", _norm(p, f"{name}.norm2_{kind}", x))
        x = x + _linear(p, f"{name}.mlp_{kind}.fc2", F.gelu(h))
    return x


def _run(p: Params, s: dict, x: torch.Tensor):
    b, f, j, chans = x.shape
    if chans == s["dim_in"] - 1:  # no confidence: 1
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    x = _linear(p, "joints_embed", x.reshape(b * f, j, -1)) + p["pos_embed"]
    x = (x.reshape(b, f, j, -1) + p["temp_embed"][:, :f]).reshape(b * f, j, -1)
    alphas = []
    for i in range(s["depth"]):
        x_st = _block(p, f"blocks_st.{i}", x, s, f, "st")
        x_ts = _block(p, f"blocks_ts.{i}", x, s, f, "ts")
        alpha = torch.softmax(_linear(p, f"ts_attn.{i}", torch.cat([x_st, x_ts], dim=-1)), -1)
        x = x_st * alpha[..., 0:1] + x_ts * alpha[..., 1:2]
        alphas.append(alpha)
    x = _norm(p, "norm", x).reshape(b, f, j, -1)
    return _linear(p, "head", torch.tanh(_linear(p, "pre_logits.fc", x))), alphas


def forward(p: Params, s: dict, x: torch.Tensor) -> torch.Tensor:
    return _run(p, s, x)[0]


def fusion_weights(p: Params, s: dict, x: torch.Tensor) -> List[torch.Tensor]:
    """Each depth's (a0, a1) of one forward, (B*F, J, 2)."""
    return _run(p, s, x)[1]


def flip(x: torch.Tensor, joints_left, joints_right) -> torch.Tensor:
    """Negate the first coordinate and swap the left and right joints."""
    perm = list(range(x.shape[-2]))
    for a, b in zip(joints_left, joints_right):
        perm[a], perm[b] = b, a
    out = x[..., perm, :].clone()
    out[..., 0] = -out[..., 0]
    return out


def lift(p: Params, s: dict, windows: torch.Tensor, joints_left, joints_right) -> torch.Tensor:
    """The poses of (W, F, J, 2) windows averaged with the mirrored input's
    mirrored poses."""
    out = forward(p, s, windows)
    mirrored = forward(p, s, flip(windows, joints_left, joints_right))
    return (out + flip(mirrored, joints_left, joints_right)) / 2


def _mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.norm(pred - target, dim=len(target.shape) - 1))


def loss_terms(pred: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """MotionBERT's fine-tuning loss on H36M (lambda_scale 0.5,
    lambda_3d_velocity 20, the other lambdas 0): loss_mpjpe, n_mpjpe (the
    per-(row, frame) least-squares scale, not detached) and
    loss_velocity."""
    norm_pred = torch.mean(torch.sum(pred**2, dim=3, keepdim=True), dim=2, keepdim=True)
    norm_tgt = torch.mean(torch.sum(target * pred, dim=3, keepdim=True), dim=2, keepdim=True)
    velocity = torch.mean(torch.norm((pred[:, 1:] - pred[:, :-1])
                                     - (target[:, 1:] - target[:, :-1]), dim=-1))
    return {"mpjpe": _mpjpe(pred, target),
            "n_mpjpe": 0.5 * _mpjpe(norm_tgt / norm_pred * pred, target),
            "velocity": 20.0 * velocity}


class AdamW:
    """torch.optim.AdamW written out: the decay multiplies the parameter by
    1 - lr * wd, then the bias-corrected Adam update."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2**self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1**self.t))
