"""Seeded synthetic pose videos, made on the device.

A frozen copy of the recipe of the PyTorch port's synthetic generators
(``manipose_tpu_torch/tools/synthetic_overfit.py::make_videos``, used by
``tools/make_synthetic_h36m.py`` and ``tools/make_synthetic_3dhp.py``):
smooth random 6D rotation trajectories (a unit normal walk low-passed by
a 41-tap Hamming window, times 1.2, about the T-pose) through forward
kinematics with fixed bone lengths, a root wandering at 3.5-4.5 m depth
(``make_synthetic_3dhp._root_path``: steps of 8 mm, a 61-tap Hamming
window), a pinhole camera with the rig's focal length, and screen
normalisation (``x / w * 2 - [1, h / w]``). Inputs are those normalised
keypoints, targets the root-relative 3D poses in metres, as the port's
loaders give them. Here the draws come from a ``torch.Generator`` on the
device, all videos of a call in one walk cut into pieces, so a few large
calls make every frame of a run.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import reference

# realistic H36M-17 bone lengths in metres (synthetic_overfit.BONE_LENGTHS)
BONE_LENGTHS = (0.13, 0.45, 0.45, 0.13, 0.45, 0.45, 0.25, 0.25, 0.12, 0.12,
                0.15, 0.28, 0.25, 0.15, 0.28, 0.25)
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _low_pass(x: torch.Tensor, taps: int) -> torch.Tensor:
    """(T, D) -> (T - taps + 1, D): a normalised Hamming window, valid part."""
    kernel = np.hamming(taps)
    kernel = kernel / kernel.sum()
    n = x.shape[0] - taps + 1
    # shifted sums in a fixed order: the same seed gives the same frames
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    for i, w in enumerate(kernel[::-1]):
        out += float(w) * x[i:i + n]
    return out


def videos(lengths: Sequence[int], camera: dict, skeleton: dict,
           generator: torch.Generator, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (keypoints (n, J, 2), root-relative poses (n, J, 3)) pair on the
    device for each length in ``lengths``."""
    joints = len(skeleton["parents"])
    total = int(sum(lengths))
    rep = torch.randn((total + 40, joints * 6), generator=generator, device=device)
    rep = _low_pass(rep, 41)[:total].view(total, joints, 6) * 1.2
    rep = rep + torch.tensor(IDENTITY_6D, device=device)
    bones = torch.tensor(BONE_LENGTHS, device=device)
    with reference.matmul_precision(False):
        pose = reference.forward_kinematics(reference.rot6d_to_matrix(rep), bones, skeleton)
    steps = torch.randn((total + 60, 3), generator=generator, device=device) * 0.008
    path = _low_pass(torch.cumsum(steps, dim=0), 61)[:total]
    # each video's root wanders about its own mean
    bounds = np.cumsum([0] + list(lengths))
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        root = path[a:b] - path[a:b].mean(dim=0, keepdim=True)
        root[:, 2] = 4.0 + 0.5 * torch.tanh(root[:, 2] * 4.0)
        cam = pose[a:b] + root[:, None, :]
        w, h = camera["res_w"], camera["res_h"]
        px = camera["focal"] * cam[..., :2] / cam[..., 2:3] + torch.tensor(
            [w / 2, h / 2], device=device)
        kp = px / w * 2 - torch.tensor([1.0, h / w], device=device)
        out.append((kp.contiguous(), pose[a:b].contiguous()))
    return out


def host(pairs) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The pairs as float32 numpy arrays, in one copy from the device."""
    if not pairs:
        return []
    flat = torch.cat([torch.cat([k.reshape(-1), p.reshape(-1)]) for k, p in pairs]).cpu().numpy()
    out, i = [], 0
    for k, p in pairs:
        nk, np_ = k.numel(), p.numel()
        out.append((flat[i:i + nk].reshape(k.shape), flat[i + nk:i + nk + np_].reshape(p.shape)))
        i += nk + np_
    return out
