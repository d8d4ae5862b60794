"""Toy conditional DDPM baseline (``toy_experiment/models/diffusion/``).

Port of ``manipose_tpu/toy/diffusion.py``: DDPM over the 2D target
conditioned on the 1D input, quad/linear/cosine noise schedules, a
sinusoidal step embedding, the noise-prediction MSE loss and ancestral
sampling of K hypotheses, all samples of a batch at once. Noise and
diffusion steps come from a ``torch.Generator`` on the model's device
(``jax.random`` streams cannot be reproduced), or are given by the caller,
as the tests give both packages the same noise. ``DiffMlp``'s BatchNorm
computes as flax's (``toy/models.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .models import _Block


def compute_noise_scheduling(
    schedule: str, beta_start: float, beta_end: float, num_steps: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(``diffusion/utils.py:35-71``). Returns (beta, alpha=cumprod,
    alpha_hat=1-beta, sigma)."""
    if schedule == "quad":
        beta = np.linspace(beta_start**0.5, beta_end**0.5, num_steps) ** 2
    elif schedule == "linear":
        beta = np.linspace(beta_start, beta_end, num_steps)
    elif schedule == "cosine":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        beta = np.array([
            min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), beta_end)
            for i in range(num_steps)
        ])
    else:
        raise ValueError(f"unknown schedule: {schedule}")
    alpha_hat = 1 - beta
    alpha = np.cumprod(alpha_hat)
    sigma = ((1.0 - alpha[:-1]) / (1.0 - alpha[1:]) * beta[1:]) ** 0.5
    return beta, alpha, alpha_hat, sigma


def _build_step_embedding(num_steps: int, dim: int) -> np.ndarray:
    """Sinusoidal table (``diffusion/utils.py:103-113``)."""
    steps = np.arange(num_steps)[:, None]
    frequencies = 10.0 ** (np.arange(dim) / (dim - 1) * 4.0)[None]
    table = steps * frequencies
    return np.concatenate([np.sin(table), np.cos(table)], axis=1)


class DiffusionEmbedding(nn.Module):
    """Projected sinusoidal step embedding (``utils.py:76-113``)."""

    def __init__(self, num_steps: int, embedding_dim: int = 128):
        super().__init__()
        table = _build_step_embedding(num_steps, embedding_dim // 2)
        self.register_buffer("table", torch.tensor(table, dtype=torch.float32),
                             persistent=False)
        self.projection1 = nn.Linear(embedding_dim, embedding_dim)
        self.projection2 = nn.Linear(embedding_dim, embedding_dim)

    def forward(self, step):
        x = F.silu(self.projection1(self.table[step]))
        return F.silu(self.projection2(x))


class DiffMlp(nn.Module):
    """MLP trunk + step embedding added after fc_in (``diff_mlp.py:8-41``)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 n_layers: int, num_diff_steps: int, act: Callable = torch.tanh):
        super().__init__()
        self.fc_in = _Block(in_features, hidden_features, act)
        self.step_enc = DiffusionEmbedding(num_diff_steps, hidden_features)
        self.fcs = nn.ModuleList(_Block(hidden_features, hidden_features, act)
                                 for _ in range(n_layers))
        self.fc_out = nn.Linear(hidden_features, out_features)

    def forward(self, x, step):
        x = self.fc_in(x) + self.step_enc(step)
        for block in self.fcs:
            x = block(x)
        return self.fc_out(x)


class LiftingDiffusionModel(nn.Module):
    """Conditional DDPM x (``in_features``-D) -> y (2D)
    (``diffusion/diffusion.py:14-176``); concat conditioning
    (``conditioners/raw_2d.py:27-38``)."""

    def __init__(self, in_features: int = 1, hidden_features: int = 32,
                 n_layers: int = 2, num_steps: int = 50, schedule: str = "cosine",
                 beta_start: float = 0.0001, beta_end: float = 0.5,
                 n_samples: int = 5, act: Callable = torch.tanh):
        super().__init__()
        beta, alpha, alpha_hat, sigma = compute_noise_scheduling(
            schedule, beta_start, beta_end, num_steps)
        for name, arr in (("beta_arr", beta), ("alpha_arr", alpha),
                          ("alpha_hat_arr", alpha_hat), ("sigma_arr", sigma)):
            self.register_buffer(name, torch.tensor(arr, dtype=torch.float32),
                                 persistent=False)
        self.num_steps, self.n_samples = num_steps, n_samples
        self.diffmodel = DiffMlp(2 + in_features, hidden_features, 2, n_layers, num_steps,
                                 act)

    def forward(self, x, y, generator: Optional[torch.Generator] = None):
        return self.calc_loss(x, y, generator=generator)

    def calc_loss(self, x, y, generator: Optional[torch.Generator] = None,
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None):
        """Noise-prediction MSE (``diffusion.py:89-118``): a step t per
        sample and the noise drawn from ``generator``, unless given."""
        b = y.shape[0]
        if t is None:
            t = torch.randint(0, self.num_steps, (b,), generator=generator, device=y.device)
        if noise is None:
            noise = torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)
        current_alpha = self.alpha_arr[t][:, None]
        noisy = torch.sqrt(current_alpha) * y + torch.sqrt(1 - current_alpha) * noise
        predicted = self.diffmodel(torch.cat([noisy, x], dim=1), t)
        return torch.mean((noise - predicted) ** 2)

    @torch.no_grad()
    def sample_hypotheses(self, x, n_samples: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None):
        """Ancestral sampling -> (B, n_samples, 2) (``diffusion.py:120-163``).
        ``noise`` (num_steps + 1, B * n_samples, 2), when given: the start,
        then each step's draw (samples of one input consecutive)."""
        n_samples = n_samples or self.n_samples
        b = x.shape[0]
        rows = b * n_samples

        def draw(i):
            if noise is not None:
                return noise[i]
            return torch.randn((rows, 2), generator=generator, device=x.device)

        training = self.diffmodel.training
        self.diffmodel.eval()  # the denoiser samples on its running statistics
        try:
            return self._sample(x, draw, b, n_samples)
        finally:
            self.diffmodel.train(training)

    def _sample(self, x, draw, b: int, n_samples: int):
        rows = b * n_samples
        target = draw(0)
        cond = torch.repeat_interleave(x, n_samples, dim=0)
        for i in range(self.num_steps):
            t = self.num_steps - 1 - i
            predicted = self.diffmodel(torch.cat([target, cond], dim=1),
                                       torch.full((rows,), t, device=x.device))
            coeff1 = 1.0 / torch.sqrt(self.alpha_hat_arr[t])
            coeff2 = (1 - self.alpha_hat_arr[t]) / torch.sqrt(1 - self.alpha_arr[t])
            mean = coeff1 * (target - coeff2 * predicted)
            step_noise = draw(i + 1)
            sigma = self.sigma_arr[t - 1] if t > 0 else 0.0
            target = mean + sigma * step_noise
        return target.reshape(b, n_samples, 2)
