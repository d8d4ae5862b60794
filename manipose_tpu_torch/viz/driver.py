"""Viz driver glue: run inference on one video and render
(``hpe/main_h36m_lifting.py:1197-1262`` + ``hpe/viz.py``).

Port of ``manipose_tpu/viz/driver.py``. The lift is the port's
``eval.engine.evaluate`` on the model's device (the card's kernels for a
model there); the drawing is ``render``'s, on the host, and needs
matplotlib, which is imported only when something is drawn.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ..eval.engine import EvalConfig, evaluate
from .prepare import prep_data_for_viz, prepare_prediction_for_viz


def render_module():
    """``viz.render``, or an ImportError that names matplotlib."""
    try:
        from . import render
    except ImportError as e:
        raise ImportError(
            f"drawing poses needs matplotlib, which does not import ({e}); "
            "lift_for_viz and viz.prepare run without it"
        ) from e
    return render


def lift_for_viz(model, loader, skeleton, cfg, rmcl, return_hyps):
    """Predictions reshaped for rendering (``hpe/eval_utils.py:226-253``):
    (N*L, J, 3) in meters, or (N*L, H, J, 4) with scores for multihyp."""
    eval_cfg = EvalConfig(tta=cfg.train.tta, rmcl=rmcl, compute_oracle=False)
    preds = evaluate(
        model, loader, skeleton, eval_cfg, return_hyps=return_hyps and rmcl
    )[0]
    preds = np.concatenate(preds, axis=0)
    if preds.ndim == 4:  # (N, L, J, 3) in mm
        n, l, j, _ = preds.shape
        return preds.reshape(n * l, j, 3) / 1000.0
    # (N, H, L, J, 4) -> (N*L, H, J, 4), xyz in mm -> m
    preds = np.transpose(preds, (0, 2, 1, 3, 4))
    n, l, h, j, _ = preds.shape
    preds = preds.reshape(n * l, h, j, 4)
    preds[..., :3] /= 1000.0
    return preds


def render_from_config(cfg, model, dataset, keypoints, rmcl,
                       figures_dir: Optional[Path] = None):
    """(``main_h36m_lifting.py:1197-1262``) The ``viz`` group's video
    lifted by ``model`` and drawn beside the ground truth into
    ``figures_dir`` (``<run.output_dir>/figures`` by default). Raises an
    ImportError naming matplotlib, before any work, where it is absent."""
    render = render_module()
    figures_dir = Path(figures_dir or Path(cfg.run.output_dir) / "figures")
    figures_dir.mkdir(parents=True, exist_ok=True)

    loader, input_keypoints, ground_truth, cam = prep_data_for_viz(
        cfg, dataset, keypoints
    )
    multihyp = bool(cfg.viz.hypothesis) and rmcl
    prediction = lift_for_viz(
        model, loader, dataset.skeleton, cfg, rmcl, multihyp
    )
    n = min(prediction.shape[0], ground_truth.shape[0])
    prediction = prepare_prediction_for_viz(
        prediction[:n], cam, multihyp=multihyp
    )
    gt_world = prepare_prediction_for_viz(ground_truth[:n], cam)
    anim_output = {"prediction": prediction, "Ground truth": gt_world}

    if cfg.viz.viz_output:
        output_name = cfg.viz.viz_output
    else:
        hyps_tag = "_hyps" if multihyp else ""
        output_name = (
            f"{cfg.model.arch}{hyps_tag}_{cfg.viz.viz_subject}_"
            f"{cfg.viz.viz_action}_{cfg.viz.viz_camera}.{cfg.viz.extension}"
        )
    output_path = figures_dir / output_name

    if cfg.viz.frame_index >= 0:
        return render.render_frame_prediction(
            input_keypoints[:n], anim_output, dataset.skeleton,
            frame_index=cfg.viz.frame_index,
            output=str(output_path.with_suffix(".png")),
            azim=cam["azimuth"],
            viewport=(cam["res_w"], cam["res_h"]),
            size=cfg.viz.viz_size,
            input_video_path=cfg.viz.viz_video,
            input_video_skip=cfg.viz.viz_skip,
        )
    return render.render_animation(
        keypoints=input_keypoints[:n],
        poses=anim_output,
        skeleton=dataset.skeleton,
        fps=dataset.fps,
        output=str(output_path),
        azim=cam["azimuth"],
        viewport=(cam["res_w"], cam["res_h"]),
        limit=cfg.viz.viz_limit,
        downsample=cfg.viz.viz_downsample,
        size=cfg.viz.viz_size,
        bitrate=cfg.viz.viz_bitrate,
        input_video_path=cfg.viz.viz_video,
        input_video_skip=cfg.viz.viz_skip,
    )
