"""Camera models: screen normalization, world<->camera, 2D projection.

The port's own copy of ``manipose_tpu/data/cameras.py``. Parity with
``hpe/mh_so3_hpe/data/camera.py``. Preprocessing transforms are host-side
numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .quaternion import qinverse, qrot


def normalize_screen_coordinates(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """Map [0, w] -> [-1, 1] preserving aspect ratio (``camera.py:9-14``)."""
    assert x.shape[-1] == 2
    return x / w * 2 - np.asarray([1, h / w], dtype=x.dtype)


def image_coordinates(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """Inverse of :func:`normalize_screen_coordinates` (``camera.py:17-21``)."""
    assert x.shape[-1] == 2
    return (x + np.asarray([1, h / w], dtype=x.dtype)) * w / 2


def world_to_camera(x: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World -> camera frame via quaternion R and translation t
    (``camera.py:24-28``)."""
    rt = qinverse(np.asarray(R))
    rt = np.broadcast_to(rt, x.shape[:-1] + (4,))
    return qrot(rt, x - t)


def camera_to_world(x: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera -> world frame (``camera.py:31-32``)."""
    r = np.broadcast_to(np.asarray(R), x.shape[:-1] + (4,))
    return qrot(r, x) + t


def project_to_2d(x: np.ndarray, camera_params: np.ndarray) -> np.ndarray:
    """Full-distortion H36M projection (``camera.py:35-70``).

    x: (N, *, 3) camera-space points; camera_params: (N, 9) =
    (f[2], c[2], k[3], p[2]).
    """
    assert x.shape[-1] == 3
    assert camera_params.ndim == 2 and camera_params.shape[-1] == 9
    assert x.shape[0] == camera_params.shape[0]
    while camera_params.ndim < x.ndim:
        camera_params = camera_params[:, None]

    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    k = camera_params[..., 4:7]
    p = camera_params[..., 7:]

    xx = np.clip(x[..., :2] / x[..., 2:], -1, 1)
    r2 = np.sum(xx**2, axis=-1, keepdims=True)
    radial = 1 + np.sum(
        k * np.concatenate([r2, r2**2, r2**3], axis=-1), axis=-1, keepdims=True
    )
    tan = np.sum(p * xx, axis=-1, keepdims=True)
    xxx = xx * (radial + tan) + p * r2
    return f * xxx + c


def project_to_2d_linear(x: np.ndarray, camera_params: np.ndarray) -> np.ndarray:
    """Linear (pinhole) projection (``camera.py:73-95``)."""
    assert x.shape[-1] == 3
    assert camera_params.ndim == 2 and camera_params.shape[-1] == 9
    assert x.shape[0] == camera_params.shape[0]
    while camera_params.ndim < x.ndim:
        camera_params = camera_params[:, None]
    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    xx = np.clip(x[..., :2] / x[..., 2:], -1, 1)
    return f * xx + c


def uvd2xyz(
    uvd: np.ndarray, f: np.ndarray, c: np.ndarray, cam_dist: np.ndarray
) -> np.ndarray:
    """Back-project (u, v, depth) to root-relative xyz (``camera.py:98-125``).

    uvd: (N, T, V, 3); f: (N, T); c: (N, T, 2); cam_dist: (N, T).
    """
    n, t, v, _ = uvd.shape
    z_global = uvd[..., 2] + cam_dist[..., None]  # (N, T, V)
    uv = uvd[..., :2] - c[:, :, None, :]  # (N, T, V, 2)
    xy = -uv * z_global[..., None] / f[:, :, None, None]
    xyz_global = np.concatenate([xy, z_global[..., None]], axis=-1)
    return xyz_global - xyz_global[:, :, :1, :]


def uvd2xyz_from_cam(uvd: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """Back-projection from the augmented 16-dim camera vector
    (``camera.py:128-143``; layout from ``data/utils.py:98-108``)."""
    cam_rot = cam[..., 9:13]
    cam_t = cam[..., 13:16]
    cam_t_in_cam_frame = qrot(qinverse(cam_rot), cam_t)
    return uvd2xyz(
        uvd,
        f=cam[..., 0],
        c=cam[..., 2:4],
        cam_dist=cam_t_in_cam_frame[..., 2],
    )
