"""Test data: the architecture module of the port's plain MixSTE
(``model.arch=mixste``), which ``test_benchmark_layout.py`` adds as
``archs/mixste.py`` to a copy of the benchmark. It keeps to the
interface that ``archs/rmcl_manifold.py`` documents.

MixSTE (Zhang et al., CVPR 2022): the MixSTE trunk over the joints, then
a LayerNorm and a Linear to 3 coordinates, one hypothesis. Its loss is
what ``train.loop.train`` builds for a model that is not rMCL: the
joint-weighted MPJPE, the velocity error and the weighted squared
velocity. It trains with the port's Adam (``harness.reference.Adam``)
and the port's loss settings (``traffic/train_steps.py``'s
``port_loss_config``), so it gives no optimizer or loss settings of its
own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from harness import reference, weights, yardstick
from harness.reference import DropPathDraws, Params, layer_norm, linear

TINY = {"model": dict(layers=1, channels=32, nheads=2)}


def shapes(cfg: dict) -> List[Tuple[str, weights.Shape]]:
    m = cfg["model"]
    joints = len(cfg["skeleton"]["parents"])
    c = m["channels"]
    out = [("Spatial_patch_to_embedding.weight", (c, 2)), ("Spatial_patch_to_embedding.bias", (c,))]
    out += weights.mixste_trunk("", c, m["layers"], joints, cfg["data"]["seq_len"],
                                m.get("mlp_ratio", 2.0))
    return out + [("head.0.weight", (c,)), ("head.0.bias", (c,)),
                  ("head.1.weight", (3, c)), ("head.1.bias", (3,))]


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.draw(shapes(cfg), seed, device,
                        lambda name: "norm" in name or name.startswith("head.0."))


def forward(p: Params, cfg: dict, x: torch.Tensor,
            draws: Optional[DropPathDraws] = None) -> torch.Tensor:
    """(B, L, J, 2) keypoints -> poses (B, L, J, 3)."""
    m = cfg["model"]
    h = linear(p, "Spatial_patch_to_embedding", x) + p["Spatial_pos_embed"]
    h = reference.mixste_trunk(p, "", h, m["layers"], m["nheads"], draws)
    return linear(p, "head.1", layer_norm(p, "head.0", h, 1e-5))


def lift_windows(p: Params, cfg: dict, x: torch.Tensor, tta: bool = True) -> torch.Tensor:
    out = forward(p, cfg, x)
    if tta:
        skeleton = cfg["skeleton"]
        out = (out + reference.flip(forward(p, cfg, reference.flip(x, skeleton)), skeleton)) / 2
    return out


def loss_terms(poses: torch.Tensor, target: torch.Tensor, train: dict) -> Dict[str, torch.Tensor]:
    w = torch.tensor(reference.JOINT_WEIGHTS, dtype=poses.dtype, device=poses.device)
    terms = {"wloss": (w * torch.linalg.vector_norm(poses - target, dim=-1)).mean()}
    vel = torch.diff(poses, dim=1)
    if train["vel_loss"] > 0:
        tvel = torch.diff(target, dim=1)
        terms["vloss"] = train["vel_loss"] * torch.linalg.vector_norm(vel - tvel, dim=-1).mean()
    if train["smooth_reg"] > 0:
        terms["sreg"] = train["smooth_reg"] * (w[:, None] * vel**2).mean()
    return terms


def train_steps(p: Params, cfg: dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                generators: Sequence[torch.Generator]) -> dict:
    t = cfg["train"]

    def loss(params, x, y, draws):
        return sum(loss_terms(forward(params, cfg, x, draws), y, t).values())

    return reference.follow_steps(p, batches, generators, cfg["model"]["drop_path_rate"], loss,
                                  lambda params: reference.Adam(params, t["lr"], t["weight_decay"]))


def _trunks(cfg: dict) -> List[dict]:
    m = cfg["model"]
    return [dict(c=m["channels"], heads=m["nheads"], depth=m["layers"],
                 n=len(cfg["skeleton"]["parents"]))]


def kernel_ops(cfg: dict, windows: int, backward: bool) -> Dict[Tuple[str, tuple], int]:
    return yardstick.mixste_kernel_ops(_trunks(cfg), cfg["data"]["seq_len"], windows, backward,
                                       cfg["model"].get("mlp_ratio", 2.0))


def model_flops(cfg: dict, windows: int) -> float:
    m, seq_len = cfg["model"], cfg["data"]["seq_len"]
    tokens = windows * seq_len * len(cfg["skeleton"]["parents"])
    total = yardstick.mixste_flops(_trunks(cfg), seq_len, windows, m.get("mlp_ratio", 2.0))
    return total + 2 * tokens * 2 * m["channels"] + 2 * tokens * m["channels"] * 3
