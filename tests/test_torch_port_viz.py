"""The port's ``viz/`` against the JAX package's, on the CPU: the data
preparation (``prep_data_for_viz``, ``prepare_prediction_for_viz`` with and
without scores), the lift (``lift_for_viz``, single- and
multi-hypothesis layouts) from the same weights, the render functions'
files, ``run.viz=true`` in the H36M driver and the viz CLI with two archs.

The archive is ``tests/test_torch_port_eval.py``'s (S11, walking 40 and
eating 31 frames, 4 cameras); the model its small config (2 layers of 32
channels, a segments trunk 16 wide, K = 2, L = 9), weights the JAX init
perturbed by 0.05 noise and carried across with
``weights.state_dict_from_jax``. Renders are a few frames at size 2.

Tolerances: the data preparation is numpy on both sides and equal; the
lift 5e-5 of max(1, |ref|max), the JAX package's model tolerance (one
eval forward with TTA a window, then a reshape).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.drivers.h36m import fetch_and_prepare_data as j_fetch_and_prepare
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.viz import driver as j_driver
from manipose_tpu.viz import prepare as j_prepare
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers.common import instantiate_model
from manipose_tpu_torch.drivers.h36m import fetch_and_prepare_data, main
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.tools import viz as viz_cli
from manipose_tpu_torch.viz import driver as t_driver
from manipose_tpu_torch.viz import prepare as t_prepare
from manipose_tpu_torch.viz import render, video
from manipose_tpu_torch.weights import state_dict_from_jax

L, J = 9, 17
OVERRIDES = [
    f"data.seq_len={L}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
    "viz.viz_action=walking", "train.batch_size_test=2",
]
MODEL_TOL = 5e-5
SKEL, J_SKEL = h36m_skeleton_17(), j_skeleton()
GIF, PNG = b"GIF8", b"\x89PNG"


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: under the suite's workers its intra-op threads
    only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    """``tests/test_torch_port_eval.py``'s seeded npz pair (S11, two
    actions, four cameras)."""
    data_dir = tmp_path_factory.mktemp("h36m_viz")
    rng = np.random.default_rng(0)
    frames = {"Walking": 40, "Eating": 31}
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={"S11": {
        a: rng.normal(scale=0.3, size=(n, 32, 3)).astype(np.float32)
        for a, n in frames.items()}})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={"S11": {
        a: [rng.uniform(0, 1000, size=(n, 17, 2)).astype(np.float32) for _ in range(4)]
        for a, n in frames.items()}})
    return data_dir


@pytest.fixture(scope="module")
def both(h36m_dir):
    """(JAX cfg, keypoints, dataset), (port cfg, keypoints, dataset)."""
    over = OVERRIDES + [f"data.data_dir={h36m_dir}"]
    j_cfg, cfg = j_load_config("config", over), load_config("config", over)
    return (j_cfg, *j_fetch_and_prepare(j_cfg)), (cfg, *fetch_and_prepare_data(cfg))


def _models(arch):
    j_model, rmcl = j_instantiate(j_load_config("config", list(OVERRIDES) + [
        f"model.arch={arch}"]), J_SKEL)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, L, J, 2)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    model, _ = instantiate_model(load_config("config", list(OVERRIDES) + [
        f"model.arch={arch}"]), SKEL)
    model.load_state_dict(state_dict_from_jax(params, arch), strict=True)
    return j_model, params, model, rmcl


def _batches(loader):
    return [(b.pose_2d, b.pose_3d, b.valid) for b in loader]


def test_prep_data_for_viz_matches_jax(both):
    """The video's loader windows, image-space keypoints, ground truth and
    camera equal the JAX package's."""
    (j_cfg, j_kps, j_ds), (cfg, kps, ds) = both
    j_loader, j_in, j_gt, j_cam = j_prepare.prep_data_for_viz(j_cfg, j_ds, j_kps)
    loader, t_in, t_gt, cam = t_prepare.prep_data_for_viz(cfg, ds, kps)
    np.testing.assert_array_equal(t_in, j_in)
    np.testing.assert_array_equal(t_gt, j_gt)
    assert t_gt.shape == (40, J, 3) and t_in.shape == (40, J, 2)
    assert sorted(cam) == sorted(j_cam)
    for k in cam:
        np.testing.assert_array_equal(np.asarray(cam[k]), np.asarray(j_cam[k]))
    got, want = _batches(loader), _batches(j_loader)
    assert len(got) == len(want) == 3  # 5 windows of 9 in batches of 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("multihyp", [False, True])
def test_prepare_prediction_for_viz_matches_jax(both, multihyp):
    """Camera -> world and the floor at the clip's lowest z (not per
    frame), scores riding along in the last channel."""
    cam = both[1][2].cameras["S11"][0]
    rng = np.random.default_rng(2)
    shape = (6, 3, J, 4) if multihyp else (6, J, 3)
    pred = rng.normal(scale=0.3, size=shape).astype(np.float32)
    got = t_prepare.prepare_prediction_for_viz(pred, cam, multihyp=multihyp)
    want = j_prepare.prepare_prediction_for_viz(pred, cam, multihyp=multihyp)
    np.testing.assert_array_equal(got, want)
    z = got[..., 2].reshape(6, -1)
    assert z.min() == 0.0 and (z.min(axis=1) > 0).any()
    if multihyp:
        np.testing.assert_array_equal(got[..., 3], pred[..., 3])


@pytest.mark.parametrize("return_hyps", [False, True])
def test_lift_for_viz_matches_jax(both, return_hyps):
    """``lift_for_viz`` (TTA on) from the same weights: (N*L, J, 3) in
    meters, or (N*L, H, J, 4) with xyz in meters and the scores as they
    are, within 5e-5 of the magnitude of the JAX package's."""
    (j_cfg, j_kps, j_ds), (cfg, kps, ds) = both
    j_model, params, model, rmcl = _models("rmcl_manifold")
    j_loader = j_prepare.prep_data_for_viz(j_cfg, j_ds, j_kps)[0]
    loader = t_prepare.prep_data_for_viz(cfg, ds, kps)[0]
    want = j_driver.lift_for_viz(j_model.apply, params, j_loader, j_ds.skeleton, j_cfg,
                                 rmcl, return_hyps)
    got = t_driver.lift_for_viz(model, loader, ds.skeleton, cfg, rmcl, return_hyps)
    assert got.shape == want.shape == ((5 * L, 2, J, 4) if return_hyps else (5 * L, J, 3))
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= MODEL_TOL * scale
    if return_hyps:  # scores in [0, 1], summing to 1 over H
        np.testing.assert_allclose(got[..., 0, 3].sum(axis=1), 1.0, atol=1e-5)


def _hyps(n=3, h=2):
    rng = np.random.default_rng(3)
    xyz = rng.normal(scale=0.3, size=(n, h, J, 3)).astype(np.float32)
    return np.concatenate([xyz, np.full((n, h, J, 1), 1.0 / h, np.float32)], axis=-1)


def _magic(path, n=4):
    with open(path, "rb") as f:
        return f.read(n)


@pytest.mark.parametrize("case", ["gif", "mp4", "frame", "rotated"])
def test_render_functions_write_their_files(tmp_path, case):
    """Each drawing writes its format: an animation GIF with single- and
    multi-hypothesis panels; ``.mp4`` through ffmpeg where it exists,
    else the GIF beside it; a PNG frame over a video's frames; the
    azimuth sweep as a GIF."""
    rng = np.random.default_rng(4)
    kps = rng.uniform(0, 1000, size=(3, J, 2)).astype(np.float32)
    poses = {"pred": rng.normal(scale=0.3, size=(3, J, 3)).astype(np.float32),
             "hyps": _hyps()}
    if case in ("gif", "mp4"):
        out = render.render_animation(kps, poses, SKEL, fps=5,
                                      output=str(tmp_path / f"anim.{case}"), size=2)
        if case == "mp4" and video.ffmpeg_available():
            assert out.endswith(".mp4") and _magic(out, 8)[4:] == b"ftyp"
        else:
            assert out == str(tmp_path / "anim.gif") and _magic(out) == GIF
    elif case == "frame":
        frames = rng.integers(0, 255, size=(4, 20, 30, 3), dtype=np.uint8)
        out = render.render_frame_prediction(kps, poses, SKEL, frame_index=1,
                                             output=str(tmp_path / "frame.png"),
                                             size=2, input_frames=frames)
        assert _magic(out) == PNG
    else:
        out = render.render_rotated_frame_prediction(
            _hyps()[0], SKEL, str(tmp_path / "rot.mp4"), azimuths=[0, 90], size=2)
        assert out.endswith("rot.gif") and _magic(out) == GIF


def test_viz_driver_writes_the_figure(h36m_dir, tmp_path):
    """``run.viz=true`` with device=cpu, no training or protocol: the
    multi-hypothesis animation of S11 walking, camera 0, in
    ``<run.output_dir>/figures``; and a frame index draws one PNG."""
    base = OVERRIDES + [f"data.data_dir={h36m_dir}", f"run.output_dir={tmp_path}",
                        "run.train=false", "run.test=false", "run.viz=true", "device=cpu",
                        "viz.viz_limit=2", "viz.viz_size=2", "viz.extension=gif"]
    assert main(load_config("config", base)) is None
    out = tmp_path / "figures" / "rmcl_manifold_hyps_S11_walking_0.gif"
    assert _magic(out) == GIF
    main(load_config("config", base + ["viz.frame_index=3", "viz.viz_output=frame.png"]))
    assert _magic(tmp_path / "figures" / "frame.png") == PNG


def test_viz_cli_draws_two_archs(h36m_dir, tmp_path, monkeypatch):
    """The viz CLI with rmcl_manifold from a reference-format ``.pth`` and
    mixste from the seeded init: one animation, panels MHMC (hypotheses
    with scores, those of the checkpoint's weights), MixSTE and the ground
    truth, each arch lifted under its own config (the sub-configs are
    copies: the second arch leaves the first's alone). Without matplotlib
    it raises an ImportError that names it, before lifting."""
    _, _, model, _ = _models("rmcl_manifold")
    torch.save({"model_pos": model.state_dict()}, tmp_path / "mhmc.pth")
    seen = {}
    real = render.render_animation

    def spy(**kw):
        seen.update(kw["poses"])
        return real(**kw)

    monkeypatch.setattr(render, "render_animation", spy)
    cfg = load_config("config", OVERRIDES + [
        f"data.data_dir={h36m_dir}", f"run.output_dir={tmp_path}", "device=cpu",
        "model.arch=rmcl_manifold,mixste", f"run.checkpoint_model={tmp_path}/mhmc.pth,",
        "viz.viz_limit=2", "viz.viz_size=2", "viz.extension=gif"])
    out = viz_cli.main(cfg)
    assert out.endswith("rmcl_manifold_mixste_S11_walking_0.gif") and _magic(out) == GIF
    assert list(seen) == ["MHMC", "MixSTE", "Ground truth"]
    assert seen["MHMC"].shape == (40, 2, J, 4) and seen["MixSTE"].shape == (40, J, 3)
    assert cfg.model.arch == "rmcl_manifold,mixste"
    sub = load_config("config", OVERRIDES + [f"data.data_dir={h36m_dir}"])
    kps, ds = fetch_and_prepare_data(sub)
    loader, _, _, cam = t_prepare.prep_data_for_viz(sub, ds, kps)
    want = t_prepare.prepare_prediction_for_viz(
        t_driver.lift_for_viz(model, loader, SKEL, sub, True, True)[:40], cam, multihyp=True)
    np.testing.assert_array_equal(seen["MHMC"], want)

    def no_render():
        raise ImportError("drawing poses needs matplotlib")

    monkeypatch.setattr(t_driver, "render_module", no_render)
    with pytest.raises(ImportError, match="matplotlib"):
        viz_cli.main(cfg)
