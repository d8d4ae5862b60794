"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. Entry points default to
    ``cuda``; asking for it without a GPU raises instead of carrying on
    quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
