"""Input-video frame reading for overlay rendering.

The port's own copy of ``manipose_tpu/viz/video.py``. Rebuild of the reference's ffmpeg-piped video decode
(``hpe/mh_so3_hpe/visualization/visualization.py:18-73``): ffprobe for
the resolution, then raw rgb24 frames streamed over a pipe. A frame
*array* can be supplied instead of a path (``load_frames(frames=...)``)
— the injection point for environments without ffmpeg and for tests.
"""

from __future__ import annotations

import shutil
import subprocess as sp
from typing import Iterator, Optional

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def get_resolution(filename: str) -> tuple:
    """(width, height) via ffprobe (``visualization.py:18-39``)."""
    command = [
        "ffprobe", "-v", "error", "-select_streams", "v:0",
        "-show_entries", "stream=width,height", "-of", "csv=p=0",
        str(filename),
    ]
    out = sp.run(command, stdout=sp.PIPE, check=True).stdout
    w, h = out.decode().strip().splitlines()[0].split(",")
    return int(w), int(h)


def read_video(filename: str, skip: int = 0, limit: int = -1) -> Iterator[np.ndarray]:
    """Yield (H, W, 3) uint8 RGB frames (``visualization.py:42-73``).

    Frames 1..skip are dropped; decoding stops after `limit` frames total
    (reference semantics: limit counts *decoded* frames incl. skipped).
    """
    if not ffmpeg_available():
        raise RuntimeError(
            "ffmpeg/ffprobe not found on PATH; pass the decoded frames as "
            "an array instead (render_animation(input_frames=...))."
        )
    w, h = get_resolution(filename)
    command = [
        "ffmpeg", "-i", str(filename), "-f", "image2pipe",
        "-pix_fmt", "rgb24", "-vsync", "0", "-vcodec", "rawvideo", "-",
    ]
    i = 0
    pipe = sp.Popen(command, stdout=sp.PIPE, stderr=sp.DEVNULL, bufsize=-1)
    try:
        while True:
            data = pipe.stdout.read(w * h * 3)
            if len(data) < w * h * 3:
                break
            i += 1
            if i > skip:
                yield np.frombuffer(data, dtype="uint8").reshape((h, w, 3))
            if i == limit:
                break
    finally:
        pipe.stdout.close()
        pipe.terminate()


def load_frames(
    input_video_path: str = "",
    input_video_skip: int = 0,
    frames: Optional[np.ndarray] = None,
    max_frames: int = -1,
) -> Optional[np.ndarray]:
    """Resolve the overlay frame stack for rendering.

    Priority: explicit `frames` array (N, H, W, 3) — sliced by skip/limit
    the same way the ffmpeg path is — then `input_video_path` via ffmpeg.
    Returns None when no video source is configured (black-background
    render, ``visualization.py:134-139``).
    """
    if frames is not None:
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"frames must be (N, H, W, 3) rgb; got {frames.shape}"
            )
        end = max_frames if max_frames >= 1 else frames.shape[0]
        out = frames[input_video_skip:end]
        if out.shape[0] == 0:
            raise ValueError(
                f"no frames left after skip={input_video_skip} of "
                f"{frames.shape[0]} (limit={max_frames})"
            )
        return out
    if input_video_path:
        out = list(
            read_video(input_video_path, skip=input_video_skip,
                       limit=max_frames)
        )
        if not out:
            raise ValueError(f"no frames decoded from {input_video_path}")
        return np.stack(out)
    return None
