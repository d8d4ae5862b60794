"""Continuous rotation representations -> SO(3), batched over any leading axes.

Port of ``manipose_tpu/geometry/rotations.py`` (6D of Zhou et al. 2019 and
the reference's custom 4D representation). The vector-norm clamp keeps the
reference's ``max(||v||, 1e-8)`` form.
"""

from __future__ import annotations

import torch

_NORM_EPS = 1e-8


def normalize_vector(v: torch.Tensor) -> torch.Tensor:
    """v / max(||v||_2, 1e-8) along the last axis (clamps the magnitude,
    not the squared magnitude)."""
    mag = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(mag, min=_NORM_EPS)


def rot6d_to_matrix(rep: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3), Gram-Schmidt style; columns are (x, y, z)."""
    x = normalize_vector(rep[..., 0:3])
    z = normalize_vector(torch.linalg.cross(x, rep[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def rot4d_to_matrix(rep: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3): two normalized (cos, sin) pairs define
    R_theta (about z) and R_phi (about x), composed."""
    cs_theta = normalize_vector(rep[..., 0:2])
    cs_phi = normalize_vector(rep[..., 2:4])
    zeros = torch.zeros_like(rep[..., :1])
    unit = torch.eye(3, dtype=rep.dtype, device=rep.device)

    theta_y = torch.cat([cs_theta, zeros], dim=-1)
    theta_z = unit[2].expand_as(theta_y)
    theta_x = torch.linalg.cross(theta_y, theta_z, dim=-1)

    phi_y = torch.cat([zeros, cs_phi], dim=-1)
    phi_x = unit[0].expand_as(phi_y)
    phi_z = torch.linalg.cross(phi_x, phi_y, dim=-1)

    r_theta = torch.stack([theta_x, theta_y, theta_z], dim=-1)
    r_phi = torch.stack([phi_x, phi_y, phi_z], dim=-1)
    return compose_rotations(r_theta, r_phi)


def compose_rotations(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3)."""
    return torch.matmul(a, b)


def rotate_vectors(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched R @ v for 3-vectors. r: (..., 3, 3), v: (..., 3)."""
    return torch.matmul(r, v.unsqueeze(-1)).squeeze(-1)


def rot_to_matrix(rep: torch.Tensor, rot_rep_dim: int) -> torch.Tensor:
    """Dispatch on representation dimension (4 or 6)."""
    if rot_rep_dim == 6:
        return rot6d_to_matrix(rep)
    if rot_rep_dim == 4:
        return rot4d_to_matrix(rep)
    raise ValueError(f"Unsupported rotation representation dim: {rot_rep_dim}")
