"""The plain PyTorch reference's shared pieces: the precision switch, the
MixSTE lineage's blocks and trunk, stochastic depth as the program draws
it, 6D rotations and forward kinematics, the mirror, the windows of a
video and of a stream, the data-parallel stepping of training and Adam.

Each architecture's reference (``archs/<arch>.py``: its forward, served
lift, loss, and an optimizer of its own where Adam is not it) is written from its published description and
builds on these. None of it imports anything of the measured program: it
reads the weights as a plain state dict under the reference
implementation's parameter names, and works out again everything the
program derives from them.

Everything is float32 and, unless ``tf32`` asks otherwise, runs with TF32
off, so that a matrix product is a float32 product. The functions take
any leading batch shape the model does; callers run them in blocks.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# Joint weights of the MixSTE lineage's weighted MPJPE (one per H36M joint).
JOINT_WEIGHTS = (1, 1, 2.5, 2.5, 1, 2.5, 2.5, 1, 1, 1, 1.5, 1.5, 4, 4, 1.5, 4, 4)


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """Matrix products in TF32 (``tf32=True``, the control) or in float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- blocks -----------------------------------------------------------------

def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def attention(p: Params, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    d = c // heads
    qkv = linear(p, name + ".qkv", x).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d**-0.5, dim=-1)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
    return linear(p, name + ".proj", out)


def block(p: Params, name: str, x: torch.Tensor, heads: int,
          masks: Optional[Tuple[torch.Tensor, torch.Tensor]], rate: float) -> torch.Tensor:
    """Pre-norm attention and MLP (exact GELU) with stochastic depth."""
    h = attention(p, name + ".attn", layer_norm(p, name + ".norm1", x, 1e-6), heads)
    if masks is not None:
        h = h * masks[0] / (1.0 - rate)
    x = x + h
    h = linear(p, name + ".mlp.fc2",
               F.gelu(linear(p, name + ".mlp.fc1", layer_norm(p, name + ".norm2", x, 1e-6))))
    if masks is not None:
        h = h * masks[1] / (1.0 - rate)
    return x + h


class DropPathDraws:
    """Stochastic-depth masks as a training forward draws them: from one
    generator on the device, per block in the order the blocks run (trunk
    by trunk as the model runs them; in each, spatial block i, then
    temporal block i), the attention branch's mask before the MLP's, one
    value a folded-batch row, none for a block whose rate is 0."""

    def __init__(self, generator: torch.Generator, drop_path_rate: float):
        self.generator = generator
        self.drop_path_rate = drop_path_rate

    def rates(self, depth: int) -> List[float]:
        return np.linspace(0.0, self.drop_path_rate, depth).tolist()

    def draw(self, rows: int, rate: float, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if rate == 0.0:
            return None
        return tuple(torch.rand((rows, 1, 1), generator=self.generator, device=device)
                     < 1.0 - rate for _ in range(2))


def mixste_trunk(p: Params, pre: str, x: torch.Tensor, depth: int, heads: int,
                 draws: Optional[DropPathDraws]) -> torch.Tensor:
    """MixSTE body on (B, L, J, C): spatial then temporal block per layer,
    each followed by its shared LayerNorm; the temporal positional table
    is added before the first temporal block."""
    b, l, j, c = x.shape
    rates = draws.rates(depth) if draws is not None else [0.0] * depth
    for i in range(depth):
        masks = draws.draw(b * l, rates[i], x.device) if draws is not None else None
        y = block(p, f"{pre}STEblocks.{i}", x.reshape(b * l, j, c), heads, masks, rates[i])
        x = layer_norm(p, pre + "Spatial_norm", y, 1e-6).reshape(b, l, j, c).transpose(1, 2)
        if i == 0:
            x = x + p[pre + "Temporal_pos_embed"]
        masks = draws.draw(b * j, rates[i], x.device) if draws is not None else None
        y = block(p, f"{pre}TTEblocks.{i}", x.reshape(b * j, l, c), heads, masks, rates[i])
        x = layer_norm(p, pre + "Temporal_norm", y, 1e-6).reshape(b, j, l, c).transpose(1, 2)
    return x


# ---- geometry ---------------------------------------------------------------

def rot6d_to_matrix(rep: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): Gram-Schmidt, columns (x, y, z); a vector
    is divided by max(|v|, 1e-8)."""
    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)

    x = unit(rep[..., 0:3])
    z = unit(torch.linalg.cross(x, rep[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def forward_kinematics(rot: torch.Tensor, lengths: torch.Tensor, skeleton: dict) -> torch.Tensor:
    """Joint by joint: world rotation = parent's world rotation @ local
    rotation; position = world rotation @ (T-pose direction * length of
    the bone ending at the joint) + parent's position; root at the origin.
    rot (..., J, 3, 3), lengths broadcastable to (..., J - 1) -> (..., J, 3)."""
    parents = skeleton["parents"]
    tpose = torch.tensor(skeleton["t_pose"], dtype=rot.dtype, device=rot.device)
    world = [rot[..., 0, :, :]]
    pos = [torch.zeros(rot.shape[:-3] + (3,), dtype=rot.dtype, device=rot.device)]
    for j in range(1, len(parents)):
        w = torch.matmul(world[parents[j]], rot[..., j, :, :])
        offset = tpose[j] * lengths[..., j - 1:j]
        pos.append(torch.matmul(w, offset.unsqueeze(-1)).squeeze(-1) + pos[parents[j]])
        world.append(w)
    return torch.stack(pos, dim=-2)


def flip(poses: torch.Tensor, skeleton: dict) -> torch.Tensor:
    """Mirror: negate the first coordinate and swap left and right joints."""
    perm = list(range(len(skeleton["parents"])))
    for a, b in zip(skeleton["joints_left"], skeleton["joints_right"]):
        perm[a], perm[b] = b, a
    out = poses[..., perm, :].clone()
    out[..., 0] = -out[..., 0]
    return out


# ---- windows ----------------------------------------------------------------

def tile_video(video: np.ndarray, seq_len: int) -> np.ndarray:
    """(N, J, 2) -> (ceil(N / L), L, J, 2): windows at 0, L, 2L, ...; the
    last one repeats the video's last frame past its end."""
    n = video.shape[0]
    idx = np.minimum(np.arange(-(-n // seq_len) * seq_len), n - 1)
    return video[idx].reshape(-1, seq_len, *video.shape[1:])


def stream_window(frames: np.ndarray, end: int, seq_len: int) -> np.ndarray:
    """The (L, J, 2) window of a live stream that ends at frame ``end``:
    frames before the stream's start repeat its first frame."""
    idx = np.maximum(np.arange(end - seq_len + 1, end + 1), 0)
    return frames[idx]


# ---- training ---------------------------------------------------------------

class Adam:
    """Adam with the weight decay added to the gradient before the moments
    (torch's ``Adam(weight_decay=...)``, not AdamW)."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """The moments' first gradients are ``grads`` plus the decay term;
        returns the gradients as the moments took them."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2**self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1**self.t))
        return taken


def follow_steps(p: Params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 generators: Sequence[torch.Generator], drop_path_rate: float,
                 loss: Callable, optimizer: Callable) -> dict:
    """Follow the training steps on ``batches`` from the weights ``p``.
    With several ``generators`` each batch is split into as many equal
    parts in order, one a data-parallel rank: each part's loss and
    drop-path masks are its own (drawn from its rank's generator), and
    the step takes the mean of their gradients and losses.

    ``loss(params, x, y, draws)``: a part's total loss; ``optimizer(params)``:
    the architecture's optimizer, whose ``step(params, grads)`` returns the
    gradients as its moments took them. Returns each step's loss, the
    gradient of every leaf as the optimizer took it at the first step, and
    the leaves' change."""
    start = {k: v.detach().clone() for k, v in p.items()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    opt = optimizer(params)
    draws = [DropPathDraws(g, drop_path_rate) for g in generators]
    losses, first_grads = [], None
    for x, y in batches:
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total_loss = 0.0
        for d, xs, ys in zip(draws, x.chunk(len(draws)), y.chunk(len(draws))):
            total = loss(params, xs, ys, d)
            for k, g in zip(params, torch.autograd.grad(total, list(params.values()))):
                grads[k] += g / len(draws)
            total_loss += float(total.detach()) / len(draws)
            del total
        taken = opt.step(params, grads)
        if first_grads is None:
            first_grads = taken
        losses.append(total_loss)
        del grads
    change = {k: (params[k].detach() - start[k]) for k in params}
    return {"losses": losses, "first_grads": first_grads, "change": change}
