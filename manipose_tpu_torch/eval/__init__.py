from .engine import flip_poses

__all__ = ["flip_poses"]
