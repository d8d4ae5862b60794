"""Skeleton rendering: animations, single frames, azimuth sweeps.

The port's own copy of ``manipose_tpu/viz/render.py`` (numpy and headless
matplotlib; nothing here runs on the card). Importing it needs matplotlib:
``viz/__init__.py`` and ``viz/driver.py`` import it only where they draw.
Rebuild of ``hpe/mh_so3_hpe/visualization/visualization.py`` on headless
matplotlib. Multi-hypothesis poses draw one skeleton per hypothesis with
alpha proportional to its plausibility score (``visualization.py:222-234``).
Videos are written with matplotlib's ffmpeg writer when available, else
a pillow GIF.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import matplotlib

matplotlib.use("Agg", force=False)
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
from matplotlib.animation import FuncAnimation, PillowWriter  # noqa: E402

from ..geometry.skeleton import Skeleton  # noqa: E402

_HYP_COLORS = ("#1b9e77", "#d95f02", "#7570b3", "#e7298a", "#66a61e",
               "#e6ab02", "#a6761d", "#666666")


def _draw_pose_3d(ax, pose, skeleton: Skeleton, color_right="red",
                  color_left="black", alpha=1.0):
    artists = []
    for j, parent in enumerate(skeleton.parents):
        if parent == -1:
            continue
        col = color_right if j in skeleton.joints_right else color_left
        artists += ax.plot(
            [pose[j, 0], pose[parent, 0]],
            [pose[j, 1], pose[parent, 1]],
            [pose[j, 2], pose[parent, 2]],
            zdir="z", c=col, alpha=alpha,
        )
    return artists


def _draw_multihyp_3d(ax, hyps, skeleton: Skeleton):
    """hyps: (H, J, 4) — xyz + score; alpha from score
    (``visualization.py:222-234``)."""
    artists = []
    for h, color in zip(range(hyps.shape[0]), _HYP_COLORS):
        score = float(hyps[h, 0, 3])
        alpha = score * 0.5 + 0.5 if score > 0.01 else 0.0
        for j, parent in enumerate(skeleton.parents):
            if parent == -1:
                continue
            artists += ax.plot(
                [hyps[h, j, 0], hyps[h, parent, 0]],
                [hyps[h, j, 1], hyps[h, parent, 1]],
                [hyps[h, j, 2], hyps[h, parent, 2]],
                zdir="z", c=color, alpha=alpha,
            )
    return artists


def _setup_3d_axis(fig, index, n_panels, title, azim, elev, radius=1.7):
    ax = fig.add_subplot(1, n_panels, index, projection="3d")
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlim3d([-radius / 2, radius / 2])
    ax.set_zlim3d([0, radius])
    ax.set_ylim3d([-radius / 2, radius / 2])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.set_title(title)
    return ax


def render_animation(
    keypoints: np.ndarray,  # (N, J, 2) image coords
    poses: Dict[str, np.ndarray],  # name -> (N, J, 3) or (N, H, J, 4)
    skeleton: Skeleton,
    fps: float,
    output: str,
    azim: float = 70.0,
    elev: float = 15.0,
    viewport=(1000, 1000),
    limit: int = -1,
    downsample: int = 1,
    size: float = 5.0,
    bitrate: int = 3000,
    input_video_path: str = "",
    input_video_skip: int = 0,
    input_frames: Optional[np.ndarray] = None,
) -> str:
    """2D input + one 3D panel per model (``visualization.py:81-318``).

    When `input_video_path` (decoded via an ffmpeg pipe,
    ``visualization.py:42-73``) or a pre-decoded `input_frames` array
    (N, H, W, 3) is given, the 2D keypoints are drawn OVER the real video
    frames (``visualization.py:163-180``); otherwise over a blank
    viewport.
    """
    from .video import load_frames

    # bound decode length: only keypoints.shape[0] frames can ever be
    # rendered (limit applies post-downsample), so stop the ffmpeg pipe
    # there instead of decoding whole videos into RAM
    frames = load_frames(
        input_video_path, input_video_skip, input_frames,
        max_frames=input_video_skip + keypoints.shape[0],
    )
    if frames is not None:
        # align lengths like the reference (:144-145)
        n = min(keypoints.shape[0], frames.shape[0])
        frames = frames[:n]
        keypoints = keypoints[:n]
        poses = {k: v[:n] for k, v in poses.items()}

    if downsample > 1:
        def ds(x):
            length = x.shape[0] // downsample * downsample
            return x[:length].reshape(-1, downsample, *x.shape[1:]).mean(1)

        keypoints = ds(keypoints)
        poses = {k: ds(v) for k, v in poses.items()}
        if frames is not None:
            frames = ds(frames).astype("uint8")
        fps = fps / downsample

    n_frames = keypoints.shape[0]
    if frames is not None:
        n_frames = min(n_frames, frames.shape[0])
    if limit >= 1:
        n_frames = min(limit, n_frames)

    n_panels = 1 + len(poses)
    fig = plt.figure(figsize=(size * n_panels, size))
    ax_in = fig.add_subplot(1, n_panels, 1)
    ax_in.set_axis_off()
    ax_in.set_title("Input")
    ax_in.set_xlim(0, viewport[0])
    ax_in.set_ylim(viewport[1], 0)
    ax_in.set_aspect("equal")

    axes_3d = [
        _setup_3d_axis(fig, i + 2, n_panels, title, azim, elev)
        for i, title in enumerate(poses.keys())
    ]
    pose_list = list(poses.values())

    state = {"artists": [], "image": None}

    def update(i):
        for artist in state["artists"]:
            artist.remove()
        state["artists"] = []
        # real-video background (kept persistent; only the data updates)
        if frames is not None:
            if state["image"] is None:
                state["image"] = ax_in.imshow(frames[i], aspect="equal")
                ax_in.set_xlim(0, frames.shape[2])
                ax_in.set_ylim(frames.shape[1], 0)
            else:
                state["image"].set_data(frames[i])
        # 2D keypoints
        for j, parent in enumerate(skeleton.parents):
            if parent == -1 or keypoints.shape[1] != skeleton.num_joints:
                continue
            state["artists"] += ax_in.plot(
                [keypoints[i, j, 0], keypoints[i, parent, 0]],
                [keypoints[i, j, 1], keypoints[i, parent, 1]],
                color="b",
            )
        state["artists"].append(
            ax_in.scatter(keypoints[i, :, 0], keypoints[i, :, 1], 5, color="red")
        )
        for ax, data in zip(axes_3d, pose_list):
            frame = data[i]
            if frame.ndim == 3:  # multi-hypothesis (H, J, 4)
                state["artists"] += _draw_multihyp_3d(ax, frame, skeleton)
            else:
                state["artists"] += _draw_pose_3d(ax, frame, skeleton)
        return state["artists"]

    anim = FuncAnimation(
        fig, update, frames=n_frames, interval=1000.0 / fps, blit=False
    )
    try:
        if str(output).endswith(".gif"):
            anim.save(output, writer=PillowWriter(fps=int(max(fps, 1))))
        else:
            anim.save(output, writer="ffmpeg", fps=int(max(fps, 1)),
                      bitrate=bitrate)
    except (FileNotFoundError, RuntimeError, ValueError):
        # no ffmpeg: fall back to GIF next to the requested path
        fallback = str(output).rsplit(".", 1)[0] + ".gif"
        anim.save(fallback, writer=PillowWriter(fps=int(max(fps, 1))))
        output = fallback
    plt.close(fig)
    return str(output)


def render_frame_prediction(
    keypoints: np.ndarray,
    poses: Dict[str, np.ndarray],
    skeleton: Skeleton,
    frame_index: int,
    output: str,
    azim: float = 70.0,
    elev: float = 15.0,
    viewport=(1000, 1000),
    size: float = 5.0,
    input_video_path: str = "",
    input_video_skip: int = 0,
    input_frames: Optional[np.ndarray] = None,
) -> str:
    """Single-frame comparison render (``visualization.py:319+``)."""
    from .video import load_frames

    # same alignment as render_animation: keypoints[i] <-> frames[i]
    # where frames start input_video_skip frames into the source video
    frames = load_frames(input_video_path, input_video_skip, input_frames,
                         max_frames=frame_index + input_video_skip + 1)
    n_panels = 1 + len(poses)
    fig = plt.figure(figsize=(size * n_panels, size))
    ax_in = fig.add_subplot(1, n_panels, 1)
    ax_in.set_axis_off()
    ax_in.set_title("Input")
    ax_in.set_xlim(0, viewport[0])
    ax_in.set_ylim(viewport[1], 0)
    if frames is not None:
        ax_in.imshow(frames[min(frame_index, frames.shape[0] - 1)],
                     aspect="equal")
        ax_in.set_xlim(0, frames.shape[2])
        ax_in.set_ylim(frames.shape[1], 0)
    for j, parent in enumerate(skeleton.parents):
        if parent == -1 or keypoints.shape[1] != skeleton.num_joints:
            continue
        ax_in.plot(
            [keypoints[frame_index, j, 0], keypoints[frame_index, parent, 0]],
            [keypoints[frame_index, j, 1], keypoints[frame_index, parent, 1]],
            color="b",
        )
    for i, (title, data) in enumerate(poses.items()):
        ax = _setup_3d_axis(fig, i + 2, n_panels, title, azim, elev)
        frame = data[frame_index]
        if frame.ndim == 3:
            _draw_multihyp_3d(ax, frame, skeleton)
        else:
            _draw_pose_3d(ax, frame, skeleton)
    fig.savefig(output, bbox_inches="tight")
    plt.close(fig)
    return str(output)


def render_rotated_frame_prediction(
    pose: np.ndarray,  # (J, 3) or (H, J, 4)
    skeleton: Skeleton,
    output: str,
    azimuths: Optional[Sequence[float]] = None,
    elev: float = 15.0,
    size: float = 5.0,
    fps: float = 10.0,
) -> str:
    """Azimuth-sweep render of one frame (``visualization.py:523+``)."""
    azimuths = (
        np.linspace(0, 360, 36, endpoint=False) if azimuths is None else azimuths
    )
    fig = plt.figure(figsize=(size, size))
    ax = _setup_3d_axis(fig, 1, 1, "", azimuths[0], elev)

    state = {"artists": []}

    def update(i):
        for artist in state["artists"]:
            artist.remove()
        ax.view_init(elev=elev, azim=azimuths[i])
        if pose.ndim == 3:
            state["artists"] = _draw_multihyp_3d(ax, pose, skeleton)
        else:
            state["artists"] = _draw_pose_3d(ax, pose, skeleton)
        return state["artists"]

    anim = FuncAnimation(fig, update, frames=len(azimuths), blit=False)
    out = str(output)
    if not out.endswith(".gif"):
        out = out.rsplit(".", 1)[0] + ".gif"
    anim.save(out, writer=PillowWriter(fps=int(fps)))
    plt.close(fig)
    return out
