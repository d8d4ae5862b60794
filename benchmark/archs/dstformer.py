"""MotionBERT's DSTformer (``model.arch=dstformer``): its plain reference,
weights, loss, AdamW and yardstick, with the interface that
``archs/rmcl_manifold.py`` documents.

Written from the published description (Zhu et al., ICCV 2023, arXiv
2210.06551; ``lib/model/DSTformer.py``, ``lib/model/loss.py`` and
``configs/pose3d/MB_ft_h36m.yaml`` of the MotionBERT repository) and the
configuration file's sizes, under MotionBERT's state-dict names. The
reference imports nothing of the measured program (``port_loss_config``
builds the program's own loss settings for the driver). On (B, F, J, 3)
keypoints (x, y, confidence; a two-channel input gets confidence 1): the
joint embedding plus the joints' and the frames' positional tables; at
each depth two
streams from the same input, ``blocks_st`` (spatial attention, MLP,
temporal attention, MLP) and ``blocks_ts`` (the temporal pair first), each
sub-block pre-norm (eps 1e-6) with a residual, joined by the learned
fusion softmax(ts_attn([x_st, x_ts])); then a LayerNorm, Linear and tanh,
and a Linear to 3 coordinates. Temporal attention splits the heads as
MotionBERT's ``forward_temporal`` does, (B*F, J, 3C) -> (B, H, J, F, d).
No drop-path, as published.

Training follows MotionBERT's fine-tuning: MPJPE + 0.5 N-MPJPE (the
per-(row, frame) least-squares scale, not detached) + 20 velocity, and
torch's AdamW. The step runs in blocks of ``BLOCK`` windows whose
gradients it sums, each weighted by its share of the rows, so that the
reference fits on the card at B = 32: every term is a mean over equal
rows, so a blocked step is the whole batch's up to rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from harness import weights, yardstick
from harness.reference import Params, flip, layer_norm, linear

TINY = {"model": dict(layers=2, channels=32, nheads=4, dim_rep=16)}
BLOCK = 8  # windows a block of the reference's training step
FUSION_SPREAD = 0.5  # each fusion's weights against a Linear's 1/sqrt(fan_in)


# ---- weights ----------------------------------------------------------------

def _sizes(cfg: dict):
    m = cfg["model"]
    return (m["channels"], int(m["channels"] * m["mlp_ratio"]), m["layers"], m["nheads"],
            m["dim_rep"], m["in_chans"], m["maxlen"], len(cfg["skeleton"]["parents"]))


def shapes(cfg: dict) -> List[Tuple[str, weights.Shape]]:
    """(name, shape) of every parameter, under MotionBERT's names."""
    c, h, depth, _, rep, chans, maxlen, joints = _sizes(cfg)
    out = [("joints_embed.weight", (c, chans)), ("joints_embed.bias", (c,)),
           ("pos_embed", (1, joints, c)), ("temp_embed", (1, maxlen, 1, c))]
    for stream in ("blocks_st", "blocks_ts"):
        for i in range(depth):
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
    out += [(f"ts_attn.{i}.{leaf}", (2, 2 * c) if leaf == "weight" else (2,))
            for i in range(depth) for leaf in ("weight", "bias")]
    return out + [("norm.weight", (c,)), ("norm.bias", (c,)),
                  ("pre_logits.fc.weight", (rep, c)), ("pre_logits.fc.bias", (rep,)),
                  ("head.weight", (3, rep)), ("head.bias", (3,))]


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights for ``seed`` (``harness.weights.draw``), each fusion's
    weights at ``FUSION_SPREAD`` of a Linear's scale: the alphas then spread
    well away from the published initialisation's 1/2 (weight 0, bias 0.5)
    without saturating the softmax, so it and its gradient do work."""

    def fusion(name, v):
        return FUSION_SPREAD * v if name.startswith("ts_attn.") and name.endswith("weight") else v

    return weights.draw(shapes(cfg), seed, device, lambda name: "norm" in name, fusion)


# ---- model ------------------------------------------------------------------

def _attention(p: Params, name: str, x: torch.Tensor, heads: int, frames: int,
               temporal: bool) -> torch.Tensor:
    bf, j, c = x.shape
    d = c // heads
    qkv = linear(p, name + ".qkv", x).reshape(bf, j, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B*F, H, J, d)
    if temporal:
        q, k, v = (t.reshape(-1, frames, heads, j, d).permute(0, 2, 3, 1, 4) for t in (q, k, v))
    out = torch.softmax((q @ k.transpose(-2, -1)) * d**-0.5, dim=-1) @ v
    if temporal:  # (B, H, J, F, d) -> (B, F, J, H, d)
        out = out.permute(0, 3, 2, 1, 4).reshape(bf, j, c)
    else:
        out = out.transpose(1, 2).reshape(bf, j, c)
    return linear(p, name + ".proj", out)


def _stream(p: Params, name: str, x: torch.Tensor, heads: int, frames: int,
            order: str) -> torch.Tensor:
    for kind in order:
        x = x + _attention(p, f"{name}.attn_{kind}",
                           layer_norm(p, f"{name}.norm1_{kind}", x, 1e-6), heads, frames,
                           kind == "t")
        h = linear(p, f"{name}.mlp_{kind}.fc1", layer_norm(p, f"{name}.norm2_{kind}", x, 1e-6))
        x = x + linear(p, f"{name}.mlp_{kind}.fc2", F.gelu(h))
    return x


def forward(p: Params, cfg: dict, x: torch.Tensor, draws=None) -> torch.Tensor:
    """(B, F, J, 3 or 2) keypoints -> poses (B, F, J, 3). ``draws`` is not
    read: the model has no drop-path."""
    _, _, depth, heads, _, chans, _, _ = _sizes(cfg)
    b, f, j, given = x.shape
    if given == chans - 1:  # no confidence: 1, as MotionBERT fills it
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    x = linear(p, "joints_embed", x.reshape(b * f, j, -1)) + p["pos_embed"]
    x = (x.reshape(b, f, j, -1) + p["temp_embed"][:, :f]).reshape(b * f, j, -1)
    for i in range(depth):
        x_st = _stream(p, f"blocks_st.{i}", x, heads, f, "st")
        x_ts = _stream(p, f"blocks_ts.{i}", x, heads, f, "ts")
        alpha = torch.softmax(linear(p, f"ts_attn.{i}", torch.cat([x_st, x_ts], dim=-1)), -1)
        x = x_st * alpha[..., 0:1] + x_ts * alpha[..., 1:2]
    x = layer_norm(p, "norm", x, 1e-6).reshape(b, f, j, -1)
    return linear(p, "head", torch.tanh(linear(p, "pre_logits.fc", x)))


def lift_windows(p: Params, cfg: dict, x: torch.Tensor, tta: bool = True) -> torch.Tensor:
    """Served poses of (B, L, J, 2) windows, averaged with the mirrored
    input's mirrored poses under ``tta``."""
    out = forward(p, cfg, x)
    if tta:
        skeleton = cfg["skeleton"]
        out = (out + flip(forward(p, cfg, flip(x, skeleton)), skeleton)) / 2
    return out


# ---- loss and optimizer -----------------------------------------------------

def _mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.norm(pred - target, dim=-1))


def loss_terms(pred: torch.Tensor, target: torch.Tensor, train: dict) -> Dict[str, torch.Tensor]:
    """MotionBERT's loss_mpjpe, n_mpjpe and loss_velocity, weighted as
    ``train`` says (N-MPJPE by ``nmpjpe``, the velocity by ``vel_loss``)."""
    norm_pred = torch.mean(torch.sum(pred**2, dim=3, keepdim=True), dim=2, keepdim=True)
    norm_tgt = torch.mean(torch.sum(target * pred, dim=3, keepdim=True), dim=2, keepdim=True)
    velocity = _mpjpe(pred[:, 1:] - pred[:, :-1], target[:, 1:] - target[:, :-1])
    return {"mpjpe": _mpjpe(pred, target),
            "n_mpjpe": train["nmpjpe"] * _mpjpe(norm_tgt / norm_pred * pred, target),
            "velocity": train["vel_loss"] * velocity}


class AdamW:
    """torch's AdamW: the parameter times 1 - lr * wd, then the
    bias-corrected Adam update; the decay never enters the moments."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """Returns the gradients as the moments took them: ``grads``."""
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2**self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1**self.t))
        return grads


def train_steps(p: Params, cfg: dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                generators: Sequence[torch.Generator], block: int = BLOCK) -> dict:
    """The reference's AdamW steps on ``batches`` from the weights ``p``:
    each batch split into as many equal parts as ``generators``, one a
    data-parallel rank, and each part into blocks of ``block`` windows; a
    block's gradient and loss weigh its share of the batch's rows. Returns
    each step's loss, the first step's gradient of every leaf, and the
    leaves' change (``harness.reference.follow_steps``'s keys)."""
    t = cfg["train"]
    start = {k: v.detach().clone() for k, v in p.items()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    opt = AdamW(params, t["lr"], t["weight_decay"])
    losses, first = [], None
    for x, y in batches:
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for xs, ys in zip(x.chunk(len(generators)), y.chunk(len(generators))):
            for i in range(0, len(xs), block):
                share = len(xs[i:i + block]) / len(x)
                loss = sum(loss_terms(forward(params, cfg, xs[i:i + block]), ys[i:i + block],
                                      t).values())
                for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
                    grads[k] += share * g
                total += share * float(loss.detach())
                del loss
        taken = opt.step(params, grads)
        first = taken if first is None else first
        losses.append(total)
    return {"losses": losses, "first_grads": first,
            "change": {k: params[k].detach() - start[k] for k in params}}


def port_loss_config(port_cfg, rmcl: bool):
    """The program's loss settings as ``train.loop.train`` builds them, with
    MotionBERT's N-MPJPE weight (``train.nmpjpe``)."""
    from manipose_tpu_torch.train.losses import LossConfig

    t = port_cfg.train
    return LossConfig(sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss,
                      smooth_reg=t.smooth_reg, rmcl_score_reg=t.rmcl_score_reg,
                      rigid_seg_reg=t.rigid_seg_reg, rmcl=rmcl, nmpjpe=t.nmpjpe)


# ---- yardstick --------------------------------------------------------------

def trunks(cfg: dict) -> List[dict]:
    """The two streams as MixSTE trunks: per depth one spatial and one
    temporal attention and two MLPs each, over the joints."""
    c, _, depth, heads, _, _, _, joints = _sizes(cfg)
    return [dict(c=c, heads=heads, depth=depth, n=joints)] * 2


def kernel_ops(cfg: dict, windows: int, backward: bool) -> Dict[Tuple[str, tuple], int]:
    """{(operation, shape): calls} of K1-K6 in one forward of ``windows``
    windows (and its backward). The fusion is counted by ``fusion_work``."""
    return yardstick.mixste_kernel_ops(trunks(cfg), cfg["data"]["seq_len"], windows, backward,
                                       cfg["model"]["mlp_ratio"])


def model_flops(cfg: dict, windows: int) -> float:
    """Matrix-product FLOPs of one forward of ``windows`` windows: the two
    streams' blocks, the joint embedding, the fusions' logits, pre_logits
    and the head. Elementwise work is not counted."""
    c, _, depth, _, rep, chans, _, _ = _sizes(cfg)
    seq_len = cfg["data"]["seq_len"]
    tokens = windows * seq_len * len(cfg["skeleton"]["parents"])
    total = yardstick.mixste_flops(trunks(cfg), seq_len, windows, cfg["model"]["mlp_ratio"])
    total += 2 * tokens * chans * c  # joints_embed
    total += depth * 2 * tokens * 2 * c * 2  # the fusions' logits
    return total + 2 * tokens * c * rep + 2 * tokens * rep * 3  # pre_logits, head


def fusion_work(cfg: dict, windows: int, backward: bool) -> Tuple[float, float]:
    """(FLOPs, bytes) of the fusions of one forward of ``windows`` windows
    (and of their backward), fp32, each input byte read once and each output
    byte written once. A fusion of R rows: forward two logits of 2C products
    a row and the blend, reading x_st and x_ts, writing x and alpha;
    backward two dot products with dx a row, the two streams' gradients and
    dW's sums, reading dx, x_st, x_ts and alpha, writing dx_st and dx_ts;
    each direction reads W and b and the backward writes dW and db."""
    c, _, depth, _, _, _, _, joints = _sizes(cfg)
    rows = windows * cfg["data"]["seq_len"] * joints
    flops = rows * (2 * 2 * 2 * c + 3 * c)
    n_bytes = 4 * (3 * rows * c + 2 * rows + 4 * c + 2)
    if backward:
        flops += rows * (2 * 2 * c + 4 * c + 4 * c)
        n_bytes += 4 * (5 * rows * c + 2 * rows + 2 * (4 * c + 2))
    return depth * flops, depth * n_bytes
