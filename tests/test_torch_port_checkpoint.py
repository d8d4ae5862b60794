"""The port's checkpoints, training-loop rules, profiling, muP and init on
the CPU, ported from what ``tests/test_driver_h36m.py:213-450``,
``tests/test_profiling.py`` and ``tests/test_torch_init.py`` check of the
JAX package:

- resume: 2 straight epochs and 1 epoch + a resumed 1 give bit-identical
  losses and weights (drop-path on: the generator, Adam's state and the
  skipped-step count are saved); ``run.auto_resume`` after a preemption;
  a kill mid-commit (a temporary directory, a numbered directory without
  its sidecar) resumes from the last committed state; discovery on
  fabricated layouts and pruning to 2;
- the loop: no validation epoch returns the final weights;
  ``TrainResult.best_params`` is a snapshot (it differs from the weights a
  later epoch trained, and equals the ``best_val`` tag);
  ``Predictor.from_any(run_dir, tag)`` and eval-only
  ``run.checkpoint_params`` load a tag; the entry points default to the
  card;
- ``ThroughputMeter`` and ``trace``;
- ``mup_lr_scales`` against the JAX package's key for key, and three
  ``make_mup_optimizer`` steps against optax's on the same gradients
  (``test_optimizer_matches_optax``'s tolerance: 1e-6 + 1e-5 relative);
- ``model.init=flax`` against the JAX init's statistics (per-tensor std
  within 3 % for tensors of 10^4 elements or more; |w| <= 2.28 /
  sqrt(fan_in) with fan-in h * c for the MCL heads; zero biases), and
  ``model.init=torch`` drawing what the port drew before flax's init.
"""

import json
import math
import shutil
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import manipose_tpu.models as jm
from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.train.mup import make_mup_optimizer as j_make_mup_optimizer
from manipose_tpu.train.mup import mup_lr_scales as j_mup_lr_scales
from manipose_tpu.train.optim import set_learning_rate
from manipose_tpu_torch import models as tm
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import create_loader, get_subjects_and_actions, instantiate_model
from manipose_tpu_torch.drivers.h36m import fetch_and_prepare_data, main
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.train.checkpoint import find_resume_state, prune_resume_states
from manipose_tpu_torch.train.loop import train
from manipose_tpu_torch.train.mup import make_mup_optimizer, mup_lr_scales
from manipose_tpu_torch.utils.profiling import ThroughputMeter, trace
from manipose_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

SMALL = [
    "data.seq_len=9", "data.data=one", "data.actions=walking,eating", "train=debug",
    "train.batch_size=4", "train.batch_size_test=4",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models on one thread: torch's intra-op threads only contend
    with the test suite's other workers for the cores (the module ran ten
    times slower under them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    """Seeded H36M-format npz files: S1, S9, S11, two actions, four
    cameras, 60 frames (``tests/test_driver_h36m.py``'s)."""
    data_dir = tmp_path_factory.mktemp("h36m_ckpt")
    rng = np.random.default_rng(0)
    subjects, actions, n_frames = ["S1", "S9", "S11"], ["Walking", "Eating"], 60
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={
        s: {a: rng.normal(scale=0.3, size=(n_frames, 32, 3)).astype(np.float32)
            for a in actions} for s in subjects})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={
        s: {a: [rng.uniform(0, 1000, size=(n_frames, 17, 2)).astype(np.float32)
                for _ in range(4)] for a in actions} for s in subjects})
    return data_dir


def _cfg(data_dir, out_dir, *extra):
    return load_config("config", SMALL + [
        f"data.data_dir={data_dir}", f"run.output_dir={out_dir}", "device=cpu",
        "run.test=false", *extra])


def _weights(run_dir, tag):
    return load_torch_checkpoint(run_dir / tag / "model.pth")


def _equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---- resume -----------------------------------------------------------------

def test_resume_is_bit_identical_on_the_cpu(h36m, tmp_path):
    """Drop-path 0.1: the epoch-2 train loss and the end weights of a run
    resumed after epoch 1 equal those of the straight run bit for bit."""
    dp = "model.drop_path_rate=0.1"
    main(_cfg(h36m, tmp_path / "straight", dp, "train.epochs=2"))
    main(_cfg(h36m, tmp_path / "part1", dp, "train.epochs=1"))
    part1 = tmp_path / "part1" / "default"
    assert find_resume_state(part1)[0] == "train_state_000001"
    main(_cfg(h36m, tmp_path / "part2", dp, "train.epochs=2",
              f"run.checkpoint_params={part1}"))
    loss_a = np.load(tmp_path / "straight" / "default" / "train_loss.npy")
    loss_b = np.load(tmp_path / "part2" / "default" / "train_loss.npy")
    assert len(loss_a) == 2 and len(loss_b) == 1
    assert loss_b[0] == loss_a[1]
    assert _equal(_weights(tmp_path / "part2" / "default", "end"),
                  _weights(tmp_path / "straight" / "default", "end"))
    state_a = torch.load(tmp_path / "straight" / "default" / "train_state_000002"
                         / "train_state.pth", weights_only=True)
    state_b = torch.load(tmp_path / "part2" / "default" / "train_state_000002"
                         / "train_state.pth", weights_only=True)
    assert torch.equal(state_a["generator"], state_b["generator"])
    assert state_a["step"] == state_b["step"] > 0


def test_auto_resume_after_preemption(h36m, tmp_path):
    """Relaunching the same command with run.auto_resume=true picks up the
    run's own newest train state: the relaunch trains epoch 2 only."""
    main(_cfg(h36m, tmp_path, "run.auto_resume=true"))  # "preempted" after 1
    main(_cfg(h36m, tmp_path, "run.auto_resume=true", "train.epochs=2"))
    assert len(np.load(tmp_path / "default" / "train_loss.npy")) == 1


def test_kill_mid_commit_resumes_from_last_committed(h36m, tmp_path):
    """A torn temporary directory and a numbered directory without its
    sidecar (a kill between commit and marker), plus a stale pointer: the
    relaunch resumes from the last committed state and trains one epoch."""
    main(_cfg(h36m, tmp_path, "run.auto_resume=true", "train.epochs=2"))
    out = tmp_path / "default"
    committed = sorted(d.name for d in out.glob("train_state_[0-9]*") if d.is_dir())
    assert committed == ["train_state_000001", "train_state_000002"]
    torn = out / "train_state_000003.torch-checkpoint-tmp-7-0"
    shutil.copytree(out / "train_state_000002", torn)
    (torn / "host_state.json").unlink()
    unmarked = out / "train_state_000004"
    shutil.copytree(out / "train_state_000002", unmarked)
    (unmarked / "host_state.json").unlink()
    (out / "train_state_host.json").write_text(
        json.dumps({"epoch": 4, "tag": "train_state_000004", "scheduler": {}}))
    tag, host = find_resume_state(out)
    assert tag == "train_state_000002" and host["epoch"] == 2
    best = main(_cfg(h36m, tmp_path, "run.auto_resume=true", "train.epochs=3"))
    assert best is not None and np.isfinite(best)
    assert len(np.load(out / "train_loss.npy")) == 1
    assert not torn.exists() and not unmarked.exists()  # pruned as debris


def test_discovery_and_pruning_on_fabricated_layouts(tmp_path):
    assert find_resume_state(tmp_path) is None
    for epoch in (1, 2, 3):
        d = tmp_path / f"train_state_{epoch:06d}"
        d.mkdir()
        (d / "host_state.json").write_text(json.dumps({"epoch": epoch}))
    # a torn commit for epoch 4: its temporary name alone proves it
    # uncommitted, even with a sidecar inside
    torn = tmp_path / "train_state_000004.torch-checkpoint-tmp-99-3"
    torn.mkdir()
    (torn / "host_state.json").write_text(json.dumps({"epoch": 4}))
    unmarked = tmp_path / "train_state_000005"  # committed, killed before its marker
    unmarked.mkdir()
    (unmarked / "model.pth").write_bytes(b"committed-bytes")
    (tmp_path / "train_state_host.json").write_text(
        json.dumps({"epoch": 5, "tag": "train_state_000005"}))
    (tmp_path / "train_state").mkdir()  # the JAX package's legacy layout: not read
    tag, host = find_resume_state(tmp_path)
    assert tag == "train_state_000003" and host["epoch"] == 3
    prune_resume_states(tmp_path, keep=2)
    left = sorted(d.name for d in tmp_path.glob("train_state_[0-9]*"))
    assert left == ["train_state_000002", "train_state_000003"]
    assert (tmp_path / "train_state").exists()


# ---- the loop -----------------------------------------------------------------

def test_no_validation_epoch_returns_final_params(h36m, tmp_path):
    """epochs < the validation and MPJPE intervals: the final weights are
    returned and tested (not the initial ones)."""
    out = tmp_path / "default"
    best = main(_cfg(h36m, tmp_path, "run.test=true", "train.valid_epoch_interval=5",
                     "train.mpjpe_epoch_interval=5"))
    assert best >= 1e9  # nothing evaluated
    assert (out / "protocol_1_err.csv").exists() and (out / "end").exists()
    assert not (out / "best_val").exists()


def _loaders(cfg):
    keypoints, dataset = fetch_and_prepare_data(cfg)
    (subjects_train, _, subjects_test), actions = get_subjects_and_actions(dataset, cfg)
    return (dataset.skeleton,
            create_loader(keypoints, dataset, actions, subjects_train, cfg, train=True),
            create_loader(keypoints, dataset, actions, subjects_test, cfg, train=False))


def test_best_params_are_a_snapshot(h36m, tmp_path):
    """Validation and MPJPE at epoch 2 only, a third epoch trains on: the
    best weights (returned, left in the model, and the best_val tag) are
    those of epoch 2, not the final ones (the end tag)."""
    cfg = _cfg(h36m, tmp_path, "train.epochs=3", "train.valid_epoch_interval=2",
               "train.mpjpe_epoch_interval=2")
    skeleton, train_loader, valid_loader = _loaders(cfg)
    model, rmcl = instantiate_model(cfg, skeleton)
    out = tmp_path / "run"
    result = train(model, cfg, skeleton, train_loader, valid_loader, out, rmcl,
                   device="cpu")
    best, end = _weights(out, "best_val"), _weights(out, "end")
    assert _equal(result.best_params, best) and _equal(_weights(out, "best_mpjpe"), best)
    assert _equal(model.state_dict(), best) and _equal(result.state.model.state_dict(), best)
    assert not _equal(best, end)
    assert len(result.train_loss) == 3 and len(result.valid_loss) == 1


def test_run_directory_tags_load(h36m, tmp_path):
    """A trained run's best_mpjpe tag through ``Predictor.from_any`` and
    through eval-only ``run.checkpoint_params``: the weights of the tag."""
    main(_cfg(h36m, tmp_path))
    run = tmp_path / "default"
    want = _weights(run, "best_mpjpe")
    cfg = _cfg(h36m, tmp_path)
    served = Predictor.from_any(str(run), tag="best_mpjpe", cfg=cfg, device="cpu")
    assert _equal(served.model.state_dict(), want)
    eval_cfg = _cfg(h36m, tmp_path / "eval", "run.train=false", "run.test=true",
                    f"run.checkpoint_params={run / 'best_mpjpe'}")
    from manipose_tpu_torch.drivers.common import maybe_restore_eval_params

    model, _ = instantiate_model(eval_cfg, h36m_skeleton_17())
    assert _equal(maybe_restore_eval_params(model, eval_cfg).state_dict(), want)
    assert main(eval_cfg) is None
    assert (tmp_path / "eval" / "default" / "protocol_1_err.csv").exists()


def test_entry_points_default_to_the_card(h36m, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("config", SMALL + [f"data.data_dir={h36m}",
                                         f"run.output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        main(cfg)
    skeleton, train_loader, valid_loader = _loaders(cfg)
    model, rmcl = instantiate_model(cfg, skeleton)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        train(model, cfg, skeleton, train_loader, valid_loader, tmp_path, rmcl)
    (tmp_path / "best_val").mkdir()
    torch.save({"model_pos": model.state_dict()}, tmp_path / "best_val" / "model.pth")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        Predictor.from_any(str(tmp_path), cfg=cfg)


# ---- profiling --------------------------------------------------------------

def test_throughput_meter():
    """The first step (kernel builds, warm-up) is left out of the window;
    zero before a timed step; reset."""
    meter = ThroughputMeter()
    assert meter.seq_per_sec == 0.0
    meter.step(16)
    time.sleep(0.05)  # must not be timed
    assert meter.seq_per_sec == 0.0
    meter.step(16)  # the clock starts here
    time.sleep(0.01)
    meter.step(16)
    time.sleep(0.01)
    assert 1000 < meter.seq_per_sec < 3200, meter.seq_per_sec
    meter.reset()
    assert meter.seq_per_sec == 0.0


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    with trace(""):
        torch.ones(3).sum()
    with trace(None):
        pass
    with trace(str(tmp_path / "prof")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---- muP ---------------------------------------------------------------------

MANIFOLD = dict(num_frame=9, embed_dim_rot=32, depth_rot=2, num_heads_rot=4,
                embed_dim_seg=16, depth_seg=2, num_heads_seg=4, n_hyp=2,
                drop_path_rate=0.0, mup=True)


@pytest.fixture(scope="module")
def mup_params():
    """The JAX init of a small muP rMCL model (jitted: the same values as
    the eager init, in a fraction of the time)."""
    j_model = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(**MANIFOLD), j_skeleton())
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 9, 17, 2)))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params):
    model = tm.RMCLManifoldMixSTE(tm.ManifoldConfig(**MANIFOLD), h36m_skeleton_17())
    model.load_state_dict(state_dict_from_jax(params, "rmcl_manifold"), strict=True)
    return model


def test_mup_lr_scales_match_jax(mup_params):
    params, model = mup_params, _port_model(mup_params)
    want = state_dict_from_jax(jax.tree_util.tree_map(
        lambda s, p: np.full(np.shape(p), s, np.float32),
        j_mup_lr_scales(params, 0.5), params), "rmcl_manifold")
    got = mup_lr_scales(model, 0.5)
    assert set(got) == set(want)
    for name, scale in got.items():
        assert torch.all(want[name] == scale), name
    assert got["rotations_module.STEblocks.0.attn.qkv.weight"] == 2.0
    assert got["rotations_module.Temporal_pos_embed"] == 2.0
    assert got["rotations_module.head.0.prediction_head.weight"] == 1.0


@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 1e-2), (1.0, 1e-6)])
def test_mup_optimizer_matches_optax(mup_params, grad_clip, weight_decay):
    """Three steps of width 32 over base 16 (scale 1/2 on the matrix-like
    weights) on the same gradients, without and with clipping. Clipped, the
    gradients fall to ~6e-3 an element, so the loop's weight decay (1e-6)
    is taken: at 1e-2 the decay term (~2e-3) cancels a gradient somewhere
    and Adam's normalization magnifies the cancellation's rounding on both
    sides alike."""
    params, model = mup_params, _port_model(mup_params)
    rng = np.random.default_rng(3)
    tx = j_make_mup_optimizer(params, width=32, base_width=16, weight_decay=weight_decay,
                              grad_clip=grad_clip)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    update = jax.jit(tx.update)
    opt = make_mup_optimizer(model, width=32, base_width=16, weight_decay=weight_decay,
                             grad_clip=grad_clip)
    named = dict(model.named_parameters())
    for lr in (1e-2, 5e-3, 2e-2):
        grads = jax.tree_util.tree_map(
            lambda p: (0.1 * rng.normal(size=np.shape(p))).astype(np.float32), params)
        set_learning_rate(j_state, lr)
        updates, j_state = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for name, g in state_dict_from_jax(grads, "rmcl_manifold").items():
            named[name].grad = g
        assert opt.step(lr)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_params), "rmcl_manifold")
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_mup_from_the_config():
    cfg = load_config("config", SMALL + ["model.mup=true", "model.mup_base_width=16"])
    from manipose_tpu_torch.train import optimizer_from_config

    model, _ = instantiate_model(cfg, h36m_skeleton_17())
    opt = optimizer_from_config(model, cfg)
    scales = {g["lr_scale"]: len(g["params"]) for g in opt.adam.param_groups}
    # qkv, proj, fc1, fc2 of 2 spatial and 2 temporal blocks, and the
    # temporal table, in each trunk (both scaled by model.channels, as JAX)
    assert set(scales) == {1.0, 0.5} and scales[0.5] == 2 * (4 * 2 * 2 + 1)


# ---- init -----------------------------------------------------------------------

def _trunk_and_heads(sd):
    """Weights of ``sd`` by name, the MCL heads' prediction and score
    weights stacked over the heads (one tensor a kind, as JAX holds them)."""
    out = {k: v for k, v in sd.items() if "prediction_head" not in k and "score_head" not in k}
    for kind in ("prediction_head", "score_head"):
        keys = sorted(k for k in sd if f"{kind}.weight" in k)
        out[f"heads.{kind}.weight"] = torch.stack([sd[k] for k in keys])
    return out


def test_flax_init_has_the_jax_distribution():
    """Flagship widths (depth 1, L 27) from the default config: per-tensor
    std within 3 % of the JAX init's for weights of 10^4 elements or more,
    every weight inside the truncation (2 / 0.8796 / sqrt(fan_in); fan-in
    h * c for the stacked MCL kernels), zero biases, unit LayerNorms, zero
    positional tables."""
    over = ["model.layers=1", "model.layers_seg=1", "data.seq_len=27"]
    j_cfg = j_load_config("config", over)
    j_model, _ = j_instantiate(j_cfg, j_skeleton())
    # init_model_params' draw (model.init unset), jitted
    params = jax.jit(j_model.init)(jax.random.PRNGKey(j_cfg.run.seed),
                                   jnp.zeros((1, 27, 17, 2), jnp.float32))
    j_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), "rmcl_manifold")
    model, _ = instantiate_model(load_config("config", over), h36m_skeleton_17())
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(sd) == set(j_sd)
    got, want = _trunk_and_heads(sd), _trunk_and_heads(j_sd)
    n_hyp = j_cfg.multi_hyp.n_hyp
    checked = 0
    for name, w in got.items():
        if name.endswith("bias") or "pos_embed" in name:
            assert torch.all(w == 0), name
        elif "norm" in name or name.endswith(".0.weight"):  # LayerNorm scales
            assert torch.all(w == 1), name
        else:
            fan_in = w.shape[-1] * (n_hyp if name.startswith("heads.") else 1)
            assert w.abs().max() <= 2.28 / math.sqrt(fan_in), name
            if w.numel() >= 10**4:
                ratio = float(w.std() / want[name].std())
                assert abs(ratio - 1) <= 0.03, (name, ratio)
                checked += 1
    assert checked >= 10
    assert got["heads.prediction_head.weight"].std() < 0.5 / math.sqrt(512)


def test_torch_init_draws_as_before():
    """model.init=torch: every Linear redrawn U(+-1/sqrt(in_features)),
    weight then bias, module by module, from a generator seeded with
    run.seed."""
    cfg = load_config("config", SMALL + ["model.init=torch"])
    model, _ = instantiate_model(cfg, h36m_skeleton_17())
    gen = torch.Generator().manual_seed(int(cfg.run.seed))
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            want = torch.empty_like(mod.weight).uniform_(-bound, bound, generator=gen)
            assert torch.equal(mod.weight.detach(), want)
            want = torch.empty_like(mod.bias).uniform_(-bound, bound, generator=gen)
            assert torch.equal(mod.bias.detach(), want)
