"""Toy models: MLP, constrained circle/torus MLPs, rMCL variants.

Port of ``manipose_tpu/toy/models.py`` (the reference's
``toy_experiment/models/``). Module names follow the flax ones
(``fc_in_dense`` -> ``fc_in.dense``, ``fcs_0_bn`` -> ``fcs.0.bn``,
``heads/kernel`` -> ``heads.kernel``), so ``weights.toy_state_dict_from_jax``
carries flax variables across. The K rMCL heads are one stacked (H, C, D)
kernel and one product, as in the JAX package. Layers take their input
width explicitly (flax infers it): 1 for the circle scenarios, 2 for the
torus.

BatchNorm computes as ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``
(:class:`BatchNorm`), which differs from ``torch.nn.BatchNorm1d`` twice:
flax's momentum 0.9 is the weight of the running value (torch's momentum
0.1), and flax updates the running variance with the biased batch
variance, where ``BatchNorm1d`` uses the unbiased one. Training mode is
``module.train()``, as in PyTorch (flax's ``train`` argument).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..train.init import _TRUNC_STD, _truncated_normal_, flax_default_init


def squared_relu(x):
    """(``models/squared_relu.py:6-11``)"""
    return torch.square(F.relu(x))


ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "sqrelu": squared_relu,
}


def torus_points_to_joints(points, major_radius=2.0, minor_radius=1.0):
    """Torus point -> (joint1 on the big circle, joint2 = point)
    (``training/metrics.py:96-109``). points: (..., 3)."""
    norm_xy = torch.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2)[..., None]
    joint1 = major_radius * points[..., :2] / norm_xy
    joint1 = torch.cat([joint1, points.new_zeros(points.shape[:-1] + (1,))], dim=-1)
    return joint1, points


def torus_angles_to_cartesian(major_radius, minor_radius, angles):
    """angles (..., 2) -> (..., 3) (``constrained_mlp.py:55-64``)."""
    ring = major_radius + minor_radius * torch.cos(angles[..., 0])
    x = ring * torch.cos(angles[..., 1])
    y = ring * torch.sin(angles[..., 1])
    z = minor_radius * torch.sin(angles[..., 0])
    return torch.stack((x, y, z), dim=-1)


class BatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` on (B, C):
    training normalizes with the batch mean and the biased batch variance
    (flax's mean(x^2) - mean(x)^2, clipped at 0) and moves the running
    statistics 0.1 of the way to them, the variance unbiased by nothing;
    eval normalizes with the running statistics."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=0)
        var = torch.clamp(torch.mean(x * x, dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class _Block(nn.Module):
    """Dense -> activation -> BatchNorm."""

    def __init__(self, in_features: int, hidden_features: int, act: Callable):
        super().__init__()
        self.dense = nn.Linear(in_features, hidden_features)
        self.bn = BatchNorm(hidden_features)
        self.act = act

    def forward(self, x):
        return self.bn(self.act(self.dense(x)))


class ToyTrunk(nn.Module):
    """The Mlp minus its output head (shared by the rMCL variants)."""

    def __init__(self, in_features: int, hidden_features: int, n_layers: int,
                 act: Callable = torch.tanh):
        super().__init__()
        self.fc_in = _Block(in_features, hidden_features, act)
        self.fcs = nn.ModuleList(_Block(hidden_features, hidden_features, act)
                                 for _ in range(n_layers))

    def forward(self, x):
        x = self.fc_in(x)
        for block in self.fcs:
            x = block(x)
        return x


class ToyMlp(ToyTrunk):
    """Dense+act+BatchNorm stacks + linear head (``models/mlp.py:5-39``)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 n_layers: int, act: Callable = torch.tanh):
        super().__init__(in_features, hidden_features, n_layers, act)
        self.fc_out = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc_out(super().forward(x))


class ConstrainedMlp(nn.Module):
    """Predict theta -> point on the circle (``constrained_mlp.py:9-35``)."""

    def __init__(self, in_features: int, hidden_features: int, n_layers: int,
                 act: Callable = torch.tanh, radius: float = 1.0):
        super().__init__()
        self.mlp = ToyMlp(in_features, hidden_features, 1, n_layers, act)
        self.radius = radius

    def forward(self, x):
        theta = self.mlp(x)
        return torch.cat([self.radius * torch.cos(theta),
                          self.radius * torch.sin(theta)], dim=1)


class ConstrainedMlpV2(nn.Module):
    """Predict 2 angles -> point on the torus (``constrained_mlp.py:37-68``)."""

    def __init__(self, in_features: int, hidden_features: int, n_layers: int,
                 act: Callable = torch.tanh, major_radius: float = 1.0,
                 minor_radius: float = 1.0):
        super().__init__()
        self.mlp = ToyMlp(in_features, hidden_features, 2, n_layers, act)
        self.major_radius, self.minor_radius = major_radius, minor_radius

    def forward(self, x):
        return torus_angles_to_cartesian(self.major_radius, self.minor_radius, self.mlp(x))


class _StackedHeads(nn.Module):
    """K heads Dense(hidden -> out+1), stacked parameters, one product."""

    def __init__(self, in_features: int, n_hyp: int, out_dim: int):
        super().__init__()
        d = out_dim + 1  # the score channel
        self.kernel = nn.Parameter(torch.empty(n_hyp, in_features, d))
        self.bias = nn.Parameter(torch.zeros(n_hyp, d))
        # flax's lecun_normal for an (h, c, d) kernel: fan-in h * c
        std = 1.0 / math.sqrt(n_hyp * in_features) / _TRUNC_STD
        with torch.no_grad():
            self.kernel.normal_(0.0, std).clamp_(-2 * std, 2 * std)

    def forward(self, x):  # (B, C) -> (B, H, out+1)
        return torch.einsum("bc,hcd->bhd", x, self.kernel) + self.bias


class ConstrainedMlpRmcl(nn.Module):
    """K circle hypotheses + scores (``constrained_mlp_rmcl.py:8-59``).

    Output (B, H, 3): (x, y, score) with scores softmaxed over H.
    """

    def __init__(self, in_features: int, hidden_features: int, n_layers: int,
                 act: Callable = torch.tanh, radius: float = 1.0, n_hyp: int = 5,
                 beta: float = 1.0):
        super().__init__()
        self.trunk = ToyTrunk(in_features, hidden_features, n_layers, act)
        self.heads = _StackedHeads(hidden_features, n_hyp, 1)
        self.radius, self.n_hyp, self.beta = radius, n_hyp, beta

    def forward(self, x):
        out = self.heads(self.trunk(x))  # (B, H, 2)
        theta, logits = out[..., 0], out[..., 1]
        scores = torch.softmax(logits, dim=1)
        return torch.stack([self.radius * torch.cos(theta),
                            self.radius * torch.sin(theta), scores], dim=-1)


class ConstrainedMlpRmclV2(nn.Module):
    """K torus hypotheses + scores (``constrained_mlp_rmcl.py:125-183``).

    Output (B, H, 4): (x, y, z, score) with scores softmaxed over H.
    """

    def __init__(self, in_features: int, hidden_features: int, n_layers: int,
                 act: Callable = torch.tanh, major_radius: float = 1.0,
                 minor_radius: float = 1.0, n_hyp: int = 5, beta: float = 1.0):
        super().__init__()
        self.trunk = ToyTrunk(in_features, hidden_features, n_layers, act)
        self.heads = _StackedHeads(hidden_features, n_hyp, 2)
        self.major_radius, self.minor_radius = major_radius, minor_radius
        self.n_hyp, self.beta = n_hyp, beta

    def forward(self, x):
        out = self.heads(self.trunk(x))  # (B, H, 3)
        points = torus_angles_to_cartesian(self.major_radius, self.minor_radius,
                                           out[..., :2])
        scores = torch.softmax(out[..., 2], dim=1)
        return torch.cat([points, scores[..., None]], dim=-1)


def init_toy_model(model: nn.Module, seed: int) -> nn.Module:
    """``model`` redrawn as flax's default init draws it, from a generator
    seeded with ``seed``: lecun-normal Dense kernels and stacked head
    kernels (fan-in n_hyp * hidden for the latter), zero biases, BatchNorm
    at ones and zeros (``train/init.py``). The draws cannot equal flax's
    (another RNG); the distribution does."""
    flax_default_init(model, seed)
    gen = torch.Generator().manual_seed(int(seed) + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _StackedHeads):
                h, c, _ = mod.kernel.shape
                _truncated_normal_(mod.kernel, 1.0 / math.sqrt(h * c) / _TRUNC_STD, gen)
                mod.bias.zero_()
    return model


# ---- aggregation + losses (``constrained_mlp_rmcl.py:60-120,185-266``) ----

def aggregate_toy_hypotheses(hypothesis: torch.Tensor, mode="weighted_ave"):
    """hypothesis (B, H, D+1) with trailing score channel -> (B, D)."""
    if mode == "weighted_ave":
        return torch.sum(hypothesis[..., :-1] * hypothesis[..., -1:], dim=1)
    if mode == "best_score":
        idx = torch.argmax(hypothesis[..., -1], dim=1)
        return hypothesis[torch.arange(hypothesis.shape[0]), idx, :-1]
    raise ValueError(f"Unknown aggregation mode: {mode}")


def _bce(probs, targets):
    """torch's BCELoss (log clipped at -100), as the JAX package writes it."""
    log_p = torch.clamp(torch.log(probs), min=-100.0)
    log_1p = torch.clamp(torch.log1p(-probs), min=-100.0)
    return torch.mean(-(targets * log_p + (1.0 - targets) * log_1p))


def _wta_and_scores(base, hypothesis, beta: float):
    wta = torch.min(base, dim=1).values
    if beta == 0:
        return torch.mean(wta)
    active = torch.argmin(base, dim=1)
    gt_scores = F.one_hot(active, hypothesis.shape[1]).to(hypothesis.dtype)
    return torch.mean(wta) + beta * _bce(hypothesis[..., -1], gt_scores)


def wta_with_scoring_l2_loss(hypothesis, y, beta: float):
    """Circle variant (``constrained_mlp_rmcl.py:81-103``): per-hyp mean
    squared error over coords, WTA + BCE on scores."""
    base = torch.mean((hypothesis[..., :-1] - y[:, None]) ** 2, dim=2)  # (B, H)
    return _wta_and_scores(base, hypothesis, beta)


def wta_with_scoring_l2_loss_v2(hypothesis, y, beta: float, major_radius: float,
                                minor_radius: float):
    """Torus variant (``constrained_mlp_rmcl.py:205-266``): per-hyp loss is
    the mean of the two joint L2 losses after the torus->joints map."""
    h1, h2 = torus_points_to_joints(hypothesis[..., :3], major_radius, minor_radius)
    y1, y2 = torus_points_to_joints(y, major_radius, minor_radius)
    err1 = torch.mean((h1 - y1[:, None]) ** 2, dim=2)
    err2 = torch.mean((h2 - y2[:, None]) ** 2, dim=2)
    return _wta_and_scores(0.5 * (err1 + err2), hypothesis, beta)
