"""Viz data preparation (``hpe/mh_so3_hpe/visualization/utils.py:41-114``).

Port of ``manipose_tpu/viz/prepare.py`` on the port's data pipeline and
camera transforms (host-side numpy)."""

from __future__ import annotations

import numpy as np

from ..data import PoseSequenceDataset, SequenceLoader
from ..data.cameras import camera_to_world, image_coordinates


def prep_data_for_viz(cfg, dataset, keypoints):
    """Pick one (subject, action, camera) video and build a sequential
    loader + image-space keypoints (``utils.py:41-99``)."""
    poses_2d_subj = {
        k.lower().split(" ")[0]: v
        for k, v in keypoints[cfg.viz.viz_subject].items()
    }
    out_poses_2d = poses_2d_subj[cfg.viz.viz_action][cfg.viz.viz_camera]
    poses_3d_subj = {
        k.lower().split(" ")[0]: v["positions_3d"]
        for k, v in {
            a: dataset[cfg.viz.viz_subject][a]
            for a in dataset[cfg.viz.viz_subject]
        }.items()
    }
    out_poses_3d = poses_3d_subj[cfg.viz.viz_action][cfg.viz.viz_camera]

    # clip length mismatches (``utils.py:63-78``)
    n = min(out_poses_3d.shape[0], out_poses_2d.shape[0])
    out_poses_3d, out_poses_2d = out_poses_3d[:n], out_poses_2d[:n]

    ground_truth = out_poses_3d.copy()
    cam = dataset.cameras[cfg.viz.viz_subject][cfg.viz.viz_camera]
    input_keypoints = image_coordinates(
        out_poses_2d[..., :2].copy(), w=cam["res_w"], h=cam["res_h"]
    )

    ds = PoseSequenceDataset(
        [out_poses_3d], [out_poses_2d], None,
        seq_len=cfg.data.seq_len, random_start=False, drop_last=False,
    )
    loader = SequenceLoader(
        ds, batch_size=cfg.train.batch_size_test, shuffle=False
    )
    return loader, input_keypoints, ground_truth, cam


def prepare_prediction_for_viz(prediction, cam, multihyp: bool = False):
    """Camera -> world frame, floor at z=0 (``utils.py:102-114``)."""
    prediction = np.array(prediction)
    scores = None
    if multihyp:
        scores = prediction[..., -1:]
        prediction = prediction[..., :-1]
    prediction = camera_to_world(prediction, R=cam["orientation"], t=0)
    prediction[..., 2] -= np.min(prediction[..., 2])
    if multihyp:
        prediction = np.concatenate((prediction, scores), axis=-1)
    return prediction
