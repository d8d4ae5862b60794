from .cameras import (
    camera_to_world,
    image_coordinates,
    normalize_screen_coordinates,
    project_to_2d,
    project_to_2d_linear,
    uvd2xyz,
    uvd2xyz_from_cam,
    world_to_camera,
)
from .h36m import (
    ALL_ACTIONS,
    Human36mDataset,
    create_2d_data,
    fetch,
    read_3d_data,
)
from .pipeline import Batch, SequenceLoader, prefetch
from .quaternion import qinverse, qrot
from .windowing import PoseSequenceDataset, make_miss_mask, pose_flip

__all__ = [
    "camera_to_world",
    "image_coordinates",
    "normalize_screen_coordinates",
    "project_to_2d",
    "project_to_2d_linear",
    "uvd2xyz",
    "uvd2xyz_from_cam",
    "world_to_camera",
    "ALL_ACTIONS",
    "Human36mDataset",
    "create_2d_data",
    "fetch",
    "read_3d_data",
    "Batch",
    "SequenceLoader",
    "prefetch",
    "qinverse",
    "qrot",
    "PoseSequenceDataset",
    "make_miss_mask",
    "pose_flip",
]
