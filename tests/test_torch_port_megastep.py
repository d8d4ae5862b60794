"""PyTorch port vs the JAX package on the megastep (``train.steps_per_call``)
and remat: the port's megastep (on the CPU, K eager steps in one call)
against ``make_multi_train_step`` of the JAX package and against K single
port steps, the skipped non-finite inner step, the training driver with
``train.steps_per_call=2`` against ``=1`` (megastep calls, the epoch's
leftover and a partial batch), and remat's gradients, generator state and
forward.

Everything runs in fp32 on the CPU with inputs made by numpy from a seed;
the JAX side takes its XLA attention.

Tolerances: stacked metrics 5e-5 relative (the JAX package's model
tolerance); parameters after K Adam steps within 2 K lr (1 - b1) /
sqrt(1 - b2), twice the most Adam can move a parameter in K steps (the
train loop's bound: where a gradient is at noise level the two sides' first
steps move it by about lr * sign(g) in either direction); the port's
megastep against its own single steps and the driver's two settings 1e-6
(the same operations in the same order); remat against the plain step
exactly (the same operations; the masks drawn before the recompute)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.models as jm
import manipose_tpu.train as jt
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu_torch import models as tm
from manipose_tpu_torch import train as tt
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import dhp3 as driver
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.tools import make_synthetic_3dhp
from manipose_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

J_SKEL, T_SKEL = j_skeleton(), t_skeleton()
MODEL = dict(num_frame=9, embed_dim_rot=32, depth_rot=2, num_heads_rot=4,
             embed_dim_seg=16, depth_seg=1, num_heads_seg=4, n_hyp=2)
K, B, LR = 3, 2, 1e-3
BETAS = (0.9, 0.999)
# the most K Adam steps can move a parameter, twice
ADAM_BOUND = 2 * K * LR * (1 - BETAS[0]) / (1 - BETAS[1]) ** 0.5


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(drop_path_rate=0.0, **MODEL), J_SKEL)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 9, 17, 2)))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _stack(seed, poison=False):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(K, B, 9, 17, 2)).astype(np.float32)
    ys = (0.1 * rng.normal(size=(K, B, 9, 17, 3))).astype(np.float32)
    if poison:
        xs[1, 0, 0, 0, 0] = np.nan  # the middle inner step
    return xs, ys


def _port(drop_path_rate=0.0, skip_nonfinite=False, remat=False):
    model = tm.RMCLManifoldMixSTE(
        tm.ManifoldConfig(drop_path_rate=drop_path_rate, remat=remat, **MODEL), T_SKEL)
    model.load_state_dict(state_dict_from_jax(_jax_params(), "rmcl_manifold"))
    opt = tt.make_optimizer(model.parameters(), weight_decay=1e-6,
                            skip_nonfinite=skip_nonfinite)
    return model, opt, tt.TrainState.create(model, opt, seed=0, device="cpu")


def _jax_megastep(xs, ys, skip_nonfinite=False):
    model = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(drop_path_rate=0.0, **MODEL), J_SKEL)
    tx = jt.make_optimizer(weight_decay=1e-6, skip_nonfinite=skip_nonfinite)
    state = jt.TrainState.create(_jax_params(), tx, jax.random.PRNGKey(1))
    multi = jt.make_multi_train_step(model.apply, jt.LossConfig(), J_SKEL, tx, n_steps=K)
    return multi(state, jnp.asarray(xs), jnp.asarray(ys), LR)


def _check_params(model, j_params):
    want = state_dict_from_jax(jax.device_get(j_params), "rmcl_manifold")
    for name, p in model.state_dict().items():
        assert (p - want[name]).abs().max().item() <= ADAM_BOUND, name


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_megastep_matches_jax(skip_nonfinite):
    """The port's megastep against the JAX package's, drop-path off: the
    stacked metrics and the parameters after the call. With skip_nonfinite
    and a NaN in the middle batch (``tests/test_train_eval.py``'s case),
    that inner step's loss is NaN, its update is dropped whole, the steps
    around it apply, and the skipped count is one."""
    xs, ys = _stack(5, poison=skip_nonfinite)
    j_state, j_metrics = _jax_megastep(xs, ys, skip_nonfinite)
    model, opt, state = _port(skip_nonfinite=skip_nonfinite)
    multi = tt.make_multi_train_step(model, tt.LossConfig(), T_SKEL, opt, K)
    metrics = multi(state, torch.from_numpy(xs), torch.from_numpy(ys), LR)
    assert set(metrics) == set(j_metrics) and state.step == K
    for key, want in j_metrics.items():
        got, want = metrics[key].numpy(), np.asarray(want)
        assert got.shape == (K,)
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=key)
        np.testing.assert_allclose(got[finite], want[finite], rtol=5e-5, atol=0,
                                   err_msg=key)
    if skip_nonfinite:
        assert not np.isfinite(float(metrics["loss"][1]))
        assert opt.notfinite_count == 1
        assert {int(s["step"]) for s in opt.adam.state.values()} == {K - 1}
    assert all(torch.isfinite(p).all() for p in model.parameters())
    _check_params(model, j_state.params)


def test_megastep_equals_single_steps_with_drop_path():
    """With drop-path on, one megastep call equals K single port steps from
    the same state: the same masks (the generator advanced alike), losses
    and parameters."""
    xs, ys = _stack(6)
    runs = []
    for multi in (False, True):
        model, opt, state = _port(drop_path_rate=0.3)
        if multi:
            step = tt.make_multi_train_step(model, tt.LossConfig(), T_SKEL, opt, K)
            losses = step(state, torch.from_numpy(xs), torch.from_numpy(ys), LR)["loss"]
        else:
            step = tt.make_train_step(model, tt.LossConfig(), T_SKEL, opt)
            losses = torch.stack([step(state, torch.from_numpy(xs[i]),
                                       torch.from_numpy(ys[i]), LR)["loss"]
                                  for i in range(K)])
        runs.append((losses, dict(model.named_parameters()), state))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert s0.step == s1.step == K
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for name, p in p0.items():
        torch.testing.assert_close(p1[name], p, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("batch_size", [4, 5])
def test_driver_megastep_equals_single_steps(tmp_path, batch_size):
    """The 3DHP driver (12 training windows) with train.steps_per_call=2
    against =1 over 2 epochs from one seed: batch 4 gives a megastep call
    and the epoch's leftover full batch as a single step; batch 5 a
    megastep call and then the partial batch of 2. The same losses and the
    same end weights."""
    archives = make_synthetic_3dhp.generate(tmp_path / "data", train_seqs=1, cams=2,
                                            frames=60, test_frames=30, seed=0)
    results = {}
    for k in (1, 2):
        out = tmp_path / f"k{k}"
        cfg = load_config("config", [
            "data=mpi_inf_3dhp", "data.seq_len=9", "train=debug", "train.epochs=2",
            f"train.batch_size={batch_size}", "train.batch_size_test=4",
            "model.layers=2", "model.channels=32", "model.nheads=4",
            "model.layers_seg=1", "model.channels_seg=16", "model.nheads_seg=4",
            "multi_hyp.n_hyp=2", "model.drop_path_rate=0.1", f"data.data_dir={archives}",
            f"run.output_dir={out}", "device=cpu", f"train.steps_per_call={k}",
            "run.test=false"])
        driver.main(cfg)
        run = out / "default"
        results[k] = (np.load(run / "train_loss.npy"),
                      load_torch_checkpoint(run / "end" / "model.pth"))
    (loss1, w1), (loss2, w2) = results[1], results[2]
    assert loss1.shape == (2,) and np.isfinite(loss1).all()
    np.testing.assert_allclose(loss2, loss1, rtol=0, atol=1e-6)
    for name, w in w1.items():
        torch.testing.assert_close(w2[name], w, rtol=0, atol=1e-6, msg=name)


def test_remat_gradients_and_generator_equal_the_plain_step():
    """A remat train step (every block recomputed in the backward pass)
    against the plain one, drop-path on, from one generator seed: the same
    loss, gradients and generator state afterwards."""
    x, y = (torch.from_numpy(a[0]) for a in _stack(7))
    runs = []
    for remat in (False, True):
        model, opt, state = _port(drop_path_rate=0.5, remat=remat)
        tt.make_train_step(model, tt.LossConfig(), T_SKEL, opt)(state, x, y, 0.0)
        runs.append(({n: p.grad.clone() for n, p in model.named_parameters()},
                     state.generator.get_state()))
    (g0, s0), (g1, s1) = runs
    assert torch.equal(s0, s1)
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name


@pytest.mark.parametrize("layout", ["fold", "joint_major"])
def test_remat_forward_matches_jax(layout):
    """The port's remat model against the JAX package's (``nn.remat``
    blocks) on the same weights, in both layouts."""
    x = np.random.default_rng(8).normal(size=(B, 9, 17, 2)).astype(np.float32)
    j_model = jm.RMCLManifoldMixSTE(
        jm.ManifoldConfig(drop_path_rate=0.0, remat=True, layout=layout, **MODEL), J_SKEL)
    want = jax.jit(j_model.apply)(_jax_params(), jnp.asarray(x))
    model, _, _ = _port(remat=True)
    if layout == "joint_major":
        joint = tm.RMCLManifoldMixSTE(
            tm.ManifoldConfig(drop_path_rate=0.0, remat=True, layout=layout, **MODEL),
            T_SKEL)
        joint.load_state_dict(model.state_dict())
        model = joint
    model.eval()
    got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= 5e-5 * max(1.0, np.abs(w).max())
