"""Quaternion ops (host-side numpy; preprocessing is CPU work).

The port's own copy of ``manipose_tpu/data/quaternion.py`` (numpy only;
the port imports nothing of the JAX package). Parity with
``hpe/mh_so3_hpe/data/quaternion.py`` (torch there)."""

from __future__ import annotations

import numpy as np


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors v by unit quaternions q. q: (..., 4), v: (..., 3)."""
    assert q.shape[-1] == 4
    assert v.shape[-1] == 3
    assert q.shape[:-1] == v.shape[:-1]
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2 * (q[..., :1] * uv + uuv)


def qinverse(q: np.ndarray) -> np.ndarray:
    """Conjugate of a unit quaternion."""
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)
