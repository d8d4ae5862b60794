"""ctypes binding of the native windowing core (``native/windowing.cpp``).

The port's own binding of the C++ source that ``manipose_tpu/data/
native.py`` binds. The library is compiled with ``g++`` at first use into
``build/native/libwindowing-<hash>.so`` under the repository root (listed
in ``.gitignore``), keyed by a hash of the source and flags, never into
``native/``. Nothing is built at import.

``gather_windows`` and ``apply_masks`` always run the library; a failed
build raises. Their numpy branches, ``gather_windows_plain`` and
``apply_masks_plain``, are the plain versions the tests hold the library
against (the same values, bit for bit).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "windowing.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libwindowing-{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        if lib.windowing_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{target.name}: unexpected ABI version")
        lib.gather_windows.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C,WRITEABLE"),
            ctypes.c_int,
        ]
        lib.gather_windows.restype = None
        lib.apply_masks.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C,WRITEABLE"),
            np.ctypeslib.ndpointer(np.float32, flags="C"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.apply_masks.restype = None
        _lib = lib
        return lib


def _check_videos(videos: Sequence[np.ndarray]) -> None:
    if any(v.shape[0] == 0 for v in videos):
        raise ValueError("empty video passed")
    # the C core receives one row stride for all videos and would read out
    # of bounds on a smaller one
    if any(v.shape[1:] != videos[0].shape[1:] for v in videos):
        raise ValueError(f"heterogeneous video shapes: {[v.shape for v in videos]}")


def gather_windows_plain(videos: Sequence[np.ndarray], video_idx: np.ndarray,
                         start_frame: np.ndarray, seq_len: int) -> np.ndarray:
    """The numpy branch of :func:`gather_windows`."""
    _check_videos(videos)
    j, c = videos[0].shape[1:]
    out = np.empty((len(video_idx), seq_len, j, c), np.float32)
    for w in range(len(video_idx)):
        v = videos[video_idx[w]]
        s = int(start_frame[w])
        clip = v[s : s + seq_len]
        if clip.shape[0] < seq_len:
            pad = np.repeat(v[-1:], seq_len - clip.shape[0], axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        out[w] = clip
    return out


def gather_windows(
    videos: Sequence[np.ndarray],  # each (n_frames, J, C)
    video_idx: np.ndarray,  # (n_windows,) int
    start_frame: np.ndarray,  # (n_windows,) int
    seq_len: int,
    n_threads: int = 0,
) -> np.ndarray:
    """-> (n_windows, seq_len, J, C) float32, replicate-padded past video
    ends, in one multithreaded pass of the native core."""
    _check_videos(videos)
    j, c = videos[0].shape[1:]
    video_idx = np.ascontiguousarray(video_idx, np.int64)
    start_frame = np.ascontiguousarray(start_frame, np.int64)
    out = np.empty((len(video_idx), seq_len, j, c), np.float32)
    lib = load_library()
    videos = [np.ascontiguousarray(v, np.float32) for v in videos]
    ptrs = (ctypes.c_void_p * len(videos))(
        *[v.ctypes.data_as(ctypes.c_void_p).value for v in videos]
    )
    lengths = np.asarray([v.shape[0] for v in videos], np.int64)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    lib.gather_windows(ptrs, lengths, j * c, video_idx, start_frame,
                       len(video_idx), seq_len, out, n_threads)
    return out


def apply_masks_plain(batch: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """The numpy branch of :func:`apply_masks`."""
    batch *= masks[..., None]
    return batch


def apply_masks(batch: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """In place batch * mask[..., None]: batch (N, L, J, C) float32
    C-contiguous, masks (N, L, J)."""
    if not batch.flags["C_CONTIGUOUS"] or batch.dtype != np.float32:
        raise ValueError("apply_masks takes a C-contiguous float32 batch")
    if masks.shape != batch.shape[:3]:
        raise ValueError(f"masks {masks.shape} do not match batch {batch.shape}")
    lib = load_library()
    n, l, j, c = batch.shape
    lib.apply_masks(batch, np.ascontiguousarray(masks, np.float32), n, l, j, c)
    return batch
