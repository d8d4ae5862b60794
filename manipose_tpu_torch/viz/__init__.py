"""Rendering of lifted poses: data preparation, the lift, animations.

Port of ``manipose_tpu/viz/``. ``prepare``, ``video`` and ``driver``'s
lift import without matplotlib (the lift runs on the card, where
matplotlib may be absent); the drawing functions of ``render`` import it
when they are first named here.
"""

from .prepare import prep_data_for_viz, prepare_prediction_for_viz
from .video import ffmpeg_available, get_resolution, load_frames, read_video

_RENDER = (
    "render_animation",
    "render_frame_prediction",
    "render_rotated_frame_prediction",
)

__all__ = [
    "prep_data_for_viz",
    "prepare_prediction_for_viz",
    *_RENDER,
    "ffmpeg_available",
    "get_resolution",
    "load_frames",
    "read_video",
]


def __getattr__(name):
    if name in _RENDER:
        from .driver import render_module

        return getattr(render_module(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
