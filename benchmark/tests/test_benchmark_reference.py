"""The plain reference against the port at a tiny size on the CPU: the
forward, the served lift with TTA, a stream's windows, and training steps
with drop-path; and the seeded inputs and weights."""

import numpy as np
import pytest
import torch

import tiny
from archs import rmcl_manifold
from harness import checks, core, reference, synth


@pytest.fixture(scope="module")
def h36m():
    torch.set_num_threads(2)
    cell = tiny.tiny(core.Cell.find("h36m-lift-videos"))
    cell.config["model"]["drop_path_rate"] = 0.1
    ctx = core.Context(cell, 2**31 + 5, 1.0, False, "cpu", 0.0)
    return ctx, rmcl_manifold.draw(cell.config, ctx.seed, "cpu")


def _model(ctx, sd):
    from manipose_tpu_torch.drivers.common import instantiate_model

    model, _ = instantiate_model(ctx.port_config(), ctx.port_skeleton())
    model.load_state_dict(sd, strict=True)
    return model


def test_weights_load_strictly_and_repeat_by_seed(h36m):
    ctx, sd = h36m
    model = _model(ctx, sd)
    assert set(model.state_dict()) == set(sd)
    again = rmcl_manifold.draw(ctx.config, ctx.seed, "cpu")
    other = rmcl_manifold.draw(ctx.config, ctx.seed + 1, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["rotations_module.STEblocks.0.attn.qkv.weight"],
                           other["rotations_module.STEblocks.0.attn.qkv.weight"])


def test_forward_matches_the_port(h36m):
    ctx, sd = h36m
    model = _model(ctx, sd).eval()
    x = synth.host(synth.videos([27 * 3], ctx.config["camera"], ctx.config["skeleton"],
                                torch.Generator().manual_seed(1), "cpu"))[0][0]
    x = torch.from_numpy(x.reshape(3, 27, 17, 2))
    with torch.no_grad():
        poses, scores = model(x)
        ref_poses, ref_scores = rmcl_manifold.forward(sd, ctx.config, x)
    assert torch.allclose(scores, ref_scores, atol=1e-6)
    assert (poses - ref_poses).abs().max() <= 1e-5 * ref_poses.abs().max()


def test_lift_and_stream_match_the_port(h36m):
    from manipose_tpu_torch.serving import Predictor

    ctx, sd = h36m
    pred = Predictor(ctx.port_config(), ctx.port_skeleton(), state_dict=sd, batch_size=2,
                     device="cpu")
    video = synth.host(synth.videos([70], ctx.config["camera"], ctx.config["skeleton"],
                                    torch.Generator().manual_seed(2), "cpu"))[0][0]
    got = pred.predict_video(video)
    with torch.no_grad():
        want = rmcl_manifold.lift_windows(sd, ctx.config, torch.from_numpy(
            reference.tile_video(video, 27))).reshape(-1, 17, 3)[:70].numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    session = pred.stream(stride=1, lookahead=13)
    emitted = np.concatenate([session.push(f) for f in video[:40]])
    wins = np.stack([reference.stream_window(video, t + 13, 27) for t in range(len(emitted))])
    with torch.no_grad():
        want = rmcl_manifold.lift_windows(sd, ctx.config, torch.from_numpy(wins))[:, 27 - 1 - 13]
    assert np.abs(emitted - want.numpy()).max() <= 1e-5 * want.abs().max().item()


def test_training_steps_match_the_port(h36m):
    from manipose_tpu_torch.train.losses import LossConfig
    from manipose_tpu_torch.train.optim import optimizer_from_config
    from manipose_tpu_torch.train.step import TrainState, make_train_step

    ctx, sd = h36m
    cfg = ctx.port_config(["model.drop_path_rate=0.1"])
    model = _model(ctx, sd)
    opt = optimizer_from_config(model, cfg)
    state = TrainState.create(model, opt, seed=99, device="cpu")
    t = cfg.train
    step = make_train_step(model, LossConfig(t.sq_loss, t.w_loss, t.vel_loss, t.smooth_reg,
                                             t.rmcl_score_reg, t.rigid_seg_reg, True),
                           ctx.port_skeleton(), opt)
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randn(3, 27, 17, 2, generator=g) * 0.3,
                torch.randn(3, 27, 17, 3, generator=g) * 0.3) for _ in range(3)]
    losses = [float(step(state, x, y, 4e-5)["loss"]) for x, y in batches]
    ref = rmcl_manifold.train_steps({k: v.clone() for k, v in sd.items()}, ctx.config, batches,
                                    [torch.Generator().manual_seed(99)])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # the harness's own measure: the worst leaf's gap of norms, over the
    # larger of its norm and the median leaf's (checks.py)
    program = {k: v - sd[k] for k, v in model.state_dict().items()}
    keep = {k: g.abs() >= 1e-3 * float(np.median([g.pow(2).mean().sqrt() for g in
                                                   ref["first_grads"].values()]))
            for k, g in ref["first_grads"].items()}
    gap, leaf = checks._worst(checks._leaf_gaps(program, ref["change"], keep))
    assert gap < 1e-3, leaf


def test_synthetic_videos_repeat_by_seed_and_look_like_keypoints():
    cam = {"focal": 1145.0, "res_w": 1000, "res_h": 1000}
    cfg = core.Cell.find("h36m-lift-videos").config
    a = synth.host(synth.videos([100, 50], cam, cfg["skeleton"], torch.Generator().manual_seed(4), "cpu"))
    b = synth.host(synth.videos([100, 50], cam, cfg["skeleton"], torch.Generator().manual_seed(4), "cpu"))
    assert [x[0].shape for x in a] == [(100, 17, 2), (50, 17, 2)]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    kp, pose = a[0]
    assert np.abs(kp).max() < 1.0 and np.all(pose[:, 0] == 0)
    bones = np.linalg.norm(pose[:, 1:] - pose[:, [p for p in cfg["skeleton"]["parents"][1:]]], axis=-1)
    assert np.allclose(bones, np.asarray(synth.BONE_LENGTHS)[None], atol=1e-5)
