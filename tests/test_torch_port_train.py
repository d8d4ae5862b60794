"""PyTorch port vs the JAX package on the training path: the losses and
regularizers (values and gradients with respect to poses and scores),
the optimizer (Adam with coupled decay, global-norm clipping, the
non-finite-step guard) and the schedules against optax and the JAX
classes, and the train and eval-loss steps of a small rMCL model from one
set of weights. Everything runs in fp32 on the CPU, deterministically
(drop-path off), with inputs made by numpy from a seed. The JAX model runs
its XLA attention here; tests/test_torch_port_grads.py holds the port's
plain backward versions against the Pallas kernels.

Tolerances: loss values 1e-5 relative and their gradients 1e-6 + 1e-5
relative (the same few fp32 reductions on both sides); optimizer states
1e-6 + 1e-5 relative; train-step losses 1e-4 relative per step and
first-step gradients 5e-4 * max(1, |g|max) per tensor (the JAX package's
MLP-gradient tolerance; two trunk blocks whose sums run in another order
on each side). Parameters after n Adam steps may differ by up to
2 * lr * n where a gradient is at noise level (Adam's first steps move a
parameter by about lr * sign(g)), so they are held at that bound and
their median error at 1e-2 * lr."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import manipose_tpu.metrics.consistency as jcons
import manipose_tpu.metrics.losses as jlosses
import manipose_tpu.models as jm
import manipose_tpu.train as jt
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.train.optim import set_learning_rate
from manipose_tpu_torch import models as tm
from manipose_tpu_torch import train as tt
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.metrics import consistency as tcons
from manipose_tpu_torch.metrics import losses as tlosses
from manipose_tpu_torch.models.mix_ste import DropPath, set_drop_path_generator
from manipose_tpu_torch.weights import state_dict_from_jax

J_SKEL, T_SKEL = j_skeleton(), t_skeleton()
B, H, L, J = 2, 3, 9, 17


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _poses(seed=0, hyp=True):
    rng = np.random.default_rng(seed)
    shape = (B, H, L, J, 3) if hyp else (B, L, J, 3)
    poses = rng.normal(size=shape).astype(np.float32)
    logits = rng.normal(size=(B, H, L, 1)).astype(np.float32)
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=1))
    target = rng.normal(size=(B, L, J, 3)).astype(np.float32)
    return poses, scores, target


# ---- losses ----------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    {}, {"sq_loss": True}, {"w_loss": False}, {"rigid_seg_reg": 0.3},
    {"rmcl_score_reg": 0.0, "smooth_reg": 0.0}, {"rmcl": False},
])
def test_compute_loss_and_its_gradients_match_jax(overrides):
    rmcl = overrides.get("rmcl", True)
    poses, scores, target = _poses(1, hyp=rmcl)
    jcfg, tcfg = jt.LossConfig(**overrides), tt.LossConfig(**overrides)

    def j_total(p, s):
        pred = (p, s) if rmcl else p
        return jt.compute_loss(pred, jnp.asarray(target), jcfg, J_SKEL)

    (want, want_terms), want_grads = jax.value_and_grad(
        j_total, argnums=(0, 1), has_aux=True
    )(jnp.asarray(poses), jnp.asarray(scores))
    p = torch.from_numpy(poses).requires_grad_()
    s = torch.from_numpy(scores).requires_grad_()
    got, got_terms = tt.compute_loss((p, s) if rmcl else p,
                                     torch.from_numpy(target), tcfg, T_SKEL)
    assert set(got_terms) == set(want_terms)
    _close(got, want)
    for k, v in want_terms.items():
        _close(got_terms[k], v, msg=k)
    got.backward()
    _close(p.grad, want_grads[0], msg="d poses")
    if rmcl:  # without the score term the scores get no gradient
        _close(torch.zeros_like(s) if s.grad is None else s.grad, want_grads[1],
               msg="d scores")


@pytest.mark.parametrize("name", [
    "mpjpe", "mpjpe_dims", "mse", "mse_weighted_dims", "velocity",
    "velocity_sq_broadcast", "bce_saturated", "smoothness",
    "smoothness_weighted", "bones",
] + [f"consistency_{m}" for m in ("std", "average", "sum", "min", "max")])
def test_metric_matches_jax(name):
    poses, scores, target = _poses(2)
    pred, y = poses[:, 0], target
    w = np.asarray(jlosses.STANDARD_H36M_WEIGHTS)
    tw = torch.tensor(tlosses.STANDARD_H36M_WEIGHTS, dtype=torch.float32)
    np.testing.assert_array_equal(tw.numpy(), w)
    probs = scores[..., 0].copy()
    probs[0, 0, :3] = (0.0, 1.0, 1e-40)  # where the -100 clamp bites
    onehot = (np.random.default_rng(3).random(probs.shape) < 0.3).astype(np.float32)
    cases = {
        "mpjpe": (lambda m, a, b, w: m.weighted_mpjpe_loss(a, b), pred, y, None),
        "mpjpe_dims": (lambda m, a, b, w: m.weighted_mpjpe_loss(a, b, w, dims=[3]),
                       poses, np.broadcast_to(y[:, None], poses.shape).copy(), w),
        "mse": (lambda m, a, b, w: m.weighted_mse_loss(a, b), pred, y, None),
        "mse_weighted_dims": (
            lambda m, a, b, w: m.weighted_mse_loss(a, b, w, dims=[3, 2]), pred, y, w),
        "velocity": (lambda m, a, b, w: m.mean_velocity_error(a, b), pred, y, None),
        "velocity_sq_broadcast": (
            lambda m, a, b, w: m.mean_velocity_error(a, b, axis=2, squared=True),
            poses, y, None),
        "bce_saturated": (lambda m, a, b, w: m.binary_cross_entropy(a, b),
                          probs, onehot, None),
    }
    if name in cases:
        fn, a, b, wt = cases[name]
        want = fn(jlosses, jnp.asarray(a), jnp.asarray(b),
                  None if wt is None else jnp.asarray(wt))
        got = fn(tlosses, torch.from_numpy(a), torch.from_numpy(b),
                 None if wt is None else tw)
    elif name.startswith("smoothness"):
        wt = name.endswith("weighted")
        want = jcons.smoothness_regularization(jnp.asarray(poses), w if wt else None, axis=2)
        got = tcons.smoothness_regularization(torch.from_numpy(poses),
                                              tw if wt else None, axis=2)
    elif name == "bones":
        want = jcons.measure_bones_length(jnp.asarray(poses), J_SKEL)
        got = tcons.measure_bones_length(torch.from_numpy(poses), T_SKEL)
    else:
        mode = name.split("_")[1]
        want = jcons.segments_time_consistency(jnp.asarray(poses), J_SKEL, mode)
        got = tcons.segments_time_consistency(torch.from_numpy(poses), T_SKEL, mode)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)


def test_wta_takes_the_first_head_on_ties():
    poses, _, target = _poses(4)
    poses[:, 2] = poses[:, 0]  # heads 0 and 2 tie everywhere
    poses[:, 1] += 5.0
    want_loss, want_idx = jlosses.wta_l2_loss_and_activate_head(
        jnp.asarray(poses), jnp.asarray(target))
    got_loss, got_idx = tlosses.wta_l2_loss_and_activate_head(
        torch.from_numpy(poses), torch.from_numpy(target))
    _close(got_loss, want_loss)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert (got_idx == 0).all()


# ---- optimizer and schedules ---------------------------------------------

def _grad_sequence(seed, n):
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        scale = 3.0 if i % 2 else 0.05  # above and below the clip norm
        seq.append({"a": (scale * rng.normal(size=(3, 4))).astype(np.float32),
                    "b": (scale * rng.normal(size=(5,))).astype(np.float32)})
    return seq


@pytest.mark.parametrize("grad_clip,skip_nonfinite", [
    (0.0, False), (1.0, False), (0.0, True), (1.0, True),
])
def test_optimizer_matches_optax(grad_clip, skip_nonfinite):
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = _grad_sequence(6, 6)
    if skip_nonfinite:
        grads[2]["b"][1] = np.nan
        grads[4]["a"][0, 0] = np.inf
    lrs = [1e-2, 5e-3, 2e-2, 1e-2, 3e-3, 1e-2]
    tx = jt.make_optimizer(weight_decay=1e-2, grad_clip=grad_clip,
                           skip_nonfinite=skip_nonfinite)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params.items()}
    opt = tt.make_optimizer(t_params.values(), weight_decay=1e-2,
                            grad_clip=grad_clip, skip_nonfinite=skip_nonfinite)
    for g, lr in zip(grads, lrs):
        set_learning_rate(j_state, lr)
        updates, j_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        applied = opt.step(lr)
        assert applied == all(np.isfinite(v).all() for v in g.values())
        for k, p in t_params.items():
            _close(p, j_params[k], msg=k)
    assert opt.notfinite_count == (2 if skip_nonfinite else 0)
    # Adam's step count advanced only on the applied steps
    steps = {int(s["step"]) for s in opt.adam.state.values()}
    assert steps == {len(grads) - opt.notfinite_count}


def test_schedules_match_jax():
    for step in (0, 3, 17):
        assert tt.lr_decay(step, 4e-5, 5, 0.95) == jt.optim.lr_decay(step, 4e-5, 5, 0.95)
    for kind in ("cosine", "plateau"):
        mine = tt.make_scheduler(kind, 4e-5, epochs=8, lr_min=1e-6,
                                 lr_patience=2, lr_threshold=0.1)
        ref = jt.optim.make_scheduler(kind, 4e-5, epochs=8, lr_min=1e-6,
                                      lr_patience=2, lr_threshold=0.1)
        for i, metric in enumerate([5.0, 4.0, 3.9, 3.95, 3.8, 3.7, 3.9, 2.0, 2.1, 2.2]):
            mine.step(metric)
            ref.step(metric)
            assert mine.lr == ref.lr and mine.state_dict() == ref.state_dict()
            if i == 4:  # a restored schedule carries on alike
                state = mine.state_dict()
                mine = tt.make_scheduler(kind, 4e-5, epochs=8, lr_min=1e-6,
                                         lr_patience=2, lr_threshold=0.1)
                mine.load_state_dict(state)
    with pytest.raises(ValueError):
        tt.make_scheduler("linear", 1e-3)


# ---- train and eval-loss steps ---------------------------------------------

# the small rMCL model of the three-step comparison: depth 2, d=64, 8
# heads, L=27, K=3, drop-path off; the accumulation and eval comparisons
# take a smaller one, which compiles faster on the JAX side
STEP_MODEL = (("num_frame", 27), ("embed_dim_rot", 64), ("depth_rot", 2),
              ("num_heads_rot", 8), ("embed_dim_seg", 32), ("depth_seg", 1),
              ("num_heads_seg", 4), ("n_hyp", 3), ("drop_path_rate", 0.0))
TINY_MODEL = (("num_frame", 9), ("embed_dim_rot", 32), ("depth_rot", 1),
              ("num_heads_rot", 4), ("embed_dim_seg", 16), ("depth_seg", 1),
              ("num_heads_seg", 4), ("n_hyp", 2), ("drop_path_rate", 0.0))
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _jax_setup(arch):
    """The JAX model of ``arch`` (one of the tuples above), perturbed
    initial params (every leaf carries signal), its optimizer and loss."""
    cfg = jm.ManifoldConfig(**dict(arch))
    model = jm.RMCLManifoldMixSTE(cfg, J_SKEL)
    x = jnp.zeros((1, cfg.num_frame, J, 2), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )
    return model, params, jt.make_optimizer(weight_decay=1e-6), jt.LossConfig()


def _batch(arch, b, seed):
    n = dict(arch)["num_frame"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, J, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(b, n, J, 3))).astype(np.float32)
    return x, y


def _port_setup(arch, accum_steps=1):
    """The port's model with the JAX params, its optimizer, state and
    train step."""
    model = tm.RMCLManifoldMixSTE(tm.ManifoldConfig(**dict(arch)), T_SKEL)
    model.load_state_dict(state_dict_from_jax(_jax_setup(arch)[1], "rmcl_manifold"),
                          strict=True)
    opt = tt.make_optimizer(model.parameters(), weight_decay=1e-6)
    state = tt.TrainState.create(model, opt, seed=0, device="cpu")
    step = tt.make_train_step(model, tt.LossConfig(), T_SKEL, opt,
                              accum_steps=accum_steps)
    return model, state, step


def _check_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=0,
                                   err_msg=k)


def _check_params(model, j_params, n_steps):
    want = state_dict_from_jax(jax.device_get(j_params), "rmcl_manifold")
    errs = []
    for name, p in model.state_dict().items():
        err = (p - want[name]).abs()
        assert err.max().item() <= 2 * LR * n_steps + 1e-6, name
        errs.append(err.flatten())
    assert torch.cat(errs).median().item() <= 1e-2 * LR


def test_three_train_steps_match_jax():
    j_model, params, tx, cfg = _jax_setup(STEP_MODEL)
    j_step = jt.make_train_step(j_model.apply, cfg, J_SKEL, tx, donate=False)
    j_state = jt.TrainState.create(params, tx, jax.random.PRNGKey(1))

    @jax.jit
    def j_grad(p, x, y):
        return jax.grad(lambda p: jt.compute_loss(
            j_model.apply(p, x), y, cfg, J_SKEL)[0])(p)

    model, state, step = _port_setup(STEP_MODEL)
    for i in range(3):
        x, y = _batch(STEP_MODEL, 2, seed=10 + i)
        if i == 0:
            # the first step's gradients, carried into the port's names by
            # the weight map (it is linear, so it maps gradients too)
            want = state_dict_from_jax(jax.device_get(j_grad(params, x, y)),
                                       "rmcl_manifold")
        j_state, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y), LR)
        metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), LR)
        _check_metrics(metrics, j_metrics)
        if i == 0:
            grads = dict(model.named_parameters())
            assert set(grads) == set(want)
            for name, g in want.items():
                got = grads[name].grad
                tol = 5e-4 * max(1.0, g.abs().max().item())
                assert (got - g).abs().max().item() <= tol, name
    assert state.step == 3
    _check_params(model, j_state.params, 3)


def test_accum_steps_and_n_valid_match_jax():
    """Two microbatches of 2, then a padded batch whose 3 valid rows do not
    split in two (the single-shot fallback)."""
    j_model, params, tx, cfg = _jax_setup(TINY_MODEL)
    j_step = jt.make_train_step(j_model.apply, cfg, J_SKEL, tx, donate=False,
                                accum_steps=2)
    j_state = jt.TrainState.create(params, tx, jax.random.PRNGKey(1))
    model, state, step = _port_setup(TINY_MODEL, accum_steps=2)
    for i, n_valid in enumerate((None, 3)):
        x, y = _batch(TINY_MODEL, 4, seed=20 + i)
        j_state, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y), LR,
                                    n_valid)
        metrics = step(state, x, y, LR, n_valid=n_valid)
        _check_metrics(metrics, j_metrics)
    _check_params(model, j_state.params, 2)


def test_eval_loss_step_matches_jax():
    j_model, params, _, cfg = _jax_setup(TINY_MODEL)
    model, _, _ = _port_setup(TINY_MODEL)
    x, y = _batch(TINY_MODEL, 3, seed=30)
    want = jt.make_eval_loss_step(j_model.apply, cfg, J_SKEL)(
        params, jnp.asarray(x), jnp.asarray(y), 2)
    got = tt.make_eval_loss_step(model, tt.LossConfig(), T_SKEL)(x, y, n_valid=2)
    _check_metrics(got, want)
    assert not model.training


def test_drop_path_draws_from_its_generator():
    x = torch.ones(64, 5, 8)
    layer = DropPath(0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        layer(x)
    global_rng = torch.get_rng_state()
    outs = []
    for _ in range(2):
        set_drop_path_generator(layer, torch.Generator().manual_seed(3))
        outs.append(layer(x))
    assert torch.equal(torch.get_rng_state(), global_rng)
    assert torch.equal(outs[0], outs[1])
    kept = outs[0][:, 0, 0] > 0
    assert 0 < kept.sum() < 64  # one mask per row
    assert torch.equal(outs[0], x * kept[:, None, None] / 0.5)
    assert torch.equal(layer.eval()(x), x)


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    model = tm.RMCLManifoldMixSTE(tm.ManifoldConfig(**dict(TINY_MODEL)), T_SKEL)
    opt = tt.make_optimizer(model.parameters())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.TrainState.create(model, opt)
