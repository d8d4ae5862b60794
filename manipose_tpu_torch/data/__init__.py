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
from .chunked import ChunkedGenerator, PoseGenerator
from .dhp3 import MAP_H36M_TO_MPI_JOINTS, Dataset3DHP, dhp3_skeleton
from .graph_utils import adj_mx_from_edges, adj_mx_from_skeleton, edges_from_parents
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
    "ChunkedGenerator",
    "PoseGenerator",
    "MAP_H36M_TO_MPI_JOINTS",
    "Dataset3DHP",
    "dhp3_skeleton",
    "adj_mx_from_edges",
    "adj_mx_from_skeleton",
    "edges_from_parents",
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
