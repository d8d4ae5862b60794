"""Side-by-side checkpoint visualizer (reference: hpe/viz.py).

The port's copy of ``scripts/viz.py``. Renders one or more checkpoints
next to the ground truth for one (subject, action, camera) video, each
lifted on the card (``device=cpu`` for the CPU), then drawn on the host
(matplotlib; checked before any lift):

  python -m manipose_tpu_torch.tools.viz run.viz=true \\
      model.arch=rmcl_manifold,mixste \\
      run.checkpoint_model=/ckpts/manipose.pth,/ckpts/mixste.pth \\
      data.data_dir=/path/to/data viz.viz_action=greeting

One checkpoint per arch, loaded strictly as a reference ``.pth``; an
empty entry takes the seeded init from ``run.seed``
(``run.checkpoint_model=a.pth,`` for the second of two archs;
``"run.checkpoint_model=','"`` for both, quoted for the YAML parser).
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..config import load_config

METHODS = {"rmcl_manifold": "MHMC", "manifold": "Manifold", "mixste": "MixSTE"}


def main(cfg) -> str:
    """Lift and draw as the module docstring says; returns the path of the
    animation written."""
    from ..config import config_from_dict
    from ..device import resolve_device
    from ..drivers.common import instantiate_model
    from ..drivers.h36m import fetch_and_prepare_data
    from ..viz.driver import lift_for_viz, render_module
    from ..viz.prepare import prep_data_for_viz, prepare_prediction_for_viz
    from ..weights import load_torch_checkpoint

    render = render_module()
    device = resolve_device(cfg.get("device", "cuda"))
    figures_dir = Path(cfg.run.output_dir) / "figures"
    figures_dir.mkdir(parents=True, exist_ok=True)

    keypoints, dataset = fetch_and_prepare_data(cfg)
    loader, input_keypoints, ground_truth, cam = prep_data_for_viz(
        cfg, dataset=dataset, keypoints=keypoints
    )

    archs = cfg.model.arch.split(",")
    checkpoints = (cfg.run.checkpoint_model or "").split(",")
    assert len(archs) == len(checkpoints), "one checkpoint per arch"

    anim_output = {}
    n_frames = None
    for arch, ckpt in zip(archs, checkpoints):
        sub_cfg = config_from_dict(dict(cfg))
        sub_cfg.model.arch = arch
        model, rmcl = instantiate_model(sub_cfg, dataset.skeleton)  # seeded init
        if ckpt:
            model.load_state_dict(load_torch_checkpoint(ckpt), strict=True)
        model.to(device)
        multihyp = bool(cfg.viz.hypothesis) and rmcl
        prediction = lift_for_viz(
            model, loader, dataset.skeleton, sub_cfg, rmcl,
            return_hyps=multihyp,
        )
        n_frames = min(
            prediction.shape[0],
            ground_truth.shape[0],
            n_frames or prediction.shape[0],
        )
        title = METHODS.get(arch, arch)
        if title in anim_output:
            # two checkpoints of the same arch: disambiguate the panel
            # title instead of silently overwriting the first
            title = f"{title} ({Path(ckpt).stem or len(anim_output)})"
        anim_output[title] = prepare_prediction_for_viz(
            prediction[:n_frames], cam, multihyp=multihyp
        )

    anim_output = {k: v[:n_frames] for k, v in anim_output.items()}
    anim_output["Ground truth"] = prepare_prediction_for_viz(
        ground_truth[:n_frames], cam
    )

    output_name = cfg.viz.viz_output or (
        f"{'_'.join(archs)}_{cfg.viz.viz_subject}_{cfg.viz.viz_action}_"
        f"{cfg.viz.viz_camera}.{cfg.viz.extension}"
    )
    out = render.render_animation(
        keypoints=input_keypoints[:n_frames],
        poses=anim_output,
        skeleton=dataset.skeleton,
        fps=dataset.fps,
        output=str(figures_dir / output_name),
        azim=cam["azimuth"],
        viewport=(cam["res_w"], cam["res_h"]),
        limit=cfg.viz.viz_limit,
        downsample=cfg.viz.viz_downsample,
        size=cfg.viz.viz_size,
        bitrate=cfg.viz.viz_bitrate,
        input_video_path=cfg.viz.viz_video,
        input_video_skip=cfg.viz.viz_skip,
    )
    print(f"Rendered: {out}")
    return out


if __name__ == "__main__":
    main(load_config("config", overrides=sys.argv[1:]))
