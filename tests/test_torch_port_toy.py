"""PyTorch port vs the JAX package on the toy experiments (``toy/``): the
distributions and datasets bit for bit on the same seeds, every toy model's
forward and BatchNorm running statistics against flax over train-mode
steps from the same weights (``weights.toy_state_dict_from_jax``), the WTA
losses and their gradients, the diffusion loss and ancestral sampling with
the JAX package's noise given to the port, and ``toy.main`` on the CPU for
every scenario and model kind at 2 epochs, against the JAX package's main
from the same initial weights where both draw no noise.

Everything runs in fp32 on the CPU.

Tolerances: model outputs and running statistics 1e-5 of max(1, |x|max)
(flax and the port compute the batch variance in one order); losses 1e-5
relative and their gradients 1e-5 of max(1, |g|max); diffusion 1e-5 of the
magnitude (8 denoising steps); the drivers' loss histories and metrics
1e-4 relative (2 epochs of Adam from the same weights and batches), but
5e-3 for hard-1 with the constrained model: its inputs sit within a few
percent of 1, where flax's one-pass batch variance (E[x^2] - E[x]^2 in
fp32, which the port keeps) cancels, so the two sides' summation orders
move the normalized features and the run apart (measured 2.3e-3 in the
loss history, 1.9e-4 in the metrics; the other runs 5e-5 and below)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.toy.distributions as jdist
import manipose_tpu.toy.models as jmod
from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.toy import diffusion as jdiff
from manipose_tpu.toy import main as jmain
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.toy import datasets as tdata
from manipose_tpu_torch.toy import diffusion as tdiff
from manipose_tpu_torch.toy import distributions as tdist
from manipose_tpu_torch.toy import main as tmain
from manipose_tpu_torch.toy import models as tmod
from manipose_tpu_torch.weights import toy_state_dict_from_jax

TOL, RUN_TOL = 1e-5, 1e-4
# runs whose BatchNorm variance cancels (see above)
RUN_TOL_CANCELLING = {("hard-1", "constrained"): 5e-3}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", ["EasyDist", "HardUnimodalDist", "HardBimodalDist",
                                  "HardQuadmodalDist", "torus"])
def test_distributions_and_datasets_match_jax(name):
    if name == "torus":
        made = [mod.torus_scenario(2.0, 1.0, 11) for mod in (tdist, jdist)]
        ds = tdata.LiftingDatasetV2
        angles = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(50, 2))
    else:
        made = [getattr(mod, name)(1.0, 11) for mod in (tdist, jdist)]
        ds = tdata.LiftingDataset
        angles = np.linspace(-np.pi, np.pi, 50)
    got, want = made
    for a, b in zip(got.sample(64), want.sample(64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.pdf(angles), want.pdf(angles))
    again = [mod.torus_scenario(2.0, 1.0, 3) if name == "torus" else
             getattr(mod, name)(1.0, 3) for mod in (tdist, jdist)]
    from manipose_tpu.toy import datasets as jdata

    j_ds = (jdata.LiftingDatasetV2 if name == "torus" else jdata.LiftingDataset)(
        again[1], 20, 10, 10)
    t_ds = ds(again[0], 20, 10, 10)
    for split in ("train", "val", "test"):
        for a, b in zip(getattr(t_ds, split), getattr(j_ds, split)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


# (flax model, port model, input width)
MODELS = {
    "mlp": (lambda: jmod.ToyMlp(16, 2, 2, jnp.tanh),
            lambda: tmod.ToyMlp(1, 16, 2, 2, torch.tanh), 1),
    "mlp-3d-relu": (lambda: jmod.ToyMlp(16, 6, 1, jax.nn.relu),
                    lambda: tmod.ToyMlp(2, 16, 6, 1, torch.relu), 2),
    "constrained": (lambda: jmod.ConstrainedMlp(16, 2, jnp.tanh, 1.0),
                    lambda: tmod.ConstrainedMlp(1, 16, 2, torch.tanh, 1.0), 1),
    "constrained-v2": (lambda: jmod.ConstrainedMlpV2(16, 2, jmod.squared_relu, 2.0, 1.0),
                       lambda: tmod.ConstrainedMlpV2(2, 16, 2, tmod.squared_relu,
                                                     2.0, 1.0), 2),
    "rmcl": (lambda: jmod.ConstrainedMlpRmcl(16, 2, jnp.tanh, 1.0, n_hyp=4),
             lambda: tmod.ConstrainedMlpRmcl(1, 16, 2, torch.tanh, 1.0, n_hyp=4), 1),
    "rmcl-v2": (lambda: jmod.ConstrainedMlpRmclV2(16, 2, jnp.tanh, 2.0, 1.0, n_hyp=4),
                lambda: tmod.ConstrainedMlpRmclV2(2, 16, 2, torch.tanh, 2.0, 1.0,
                                                  n_hyp=4), 2),
}


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, msg
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), msg


@pytest.mark.parametrize("name", list(MODELS))
def test_toy_models_match_flax(name):
    """Three train-mode steps (each updating the BatchNorm statistics) on
    different batches, then the eval forward: outputs and running
    statistics as flax's."""
    make_j, make_t, width = MODELS[name]
    j_model, t_model = make_j(), make_t()
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(2, width)).astype(np.float32)
    variables = _np(j_model.init(jax.random.PRNGKey(2), x0, train=False))
    t_model.load_state_dict(toy_state_dict_from_jax(variables), strict=True)
    t_model.train()
    for _ in range(3):
        x = rng.normal(size=(16, width)).astype(np.float32)
        out, updates = j_model.apply(variables, x, train=True, mutable=["batch_stats"])
        variables = {**variables, **_np(updates)}
        _close(t_model(torch.from_numpy(x)).detach(), out, msg=name)
    stats = toy_state_dict_from_jax(variables)
    for key, value in t_model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            _close(value, stats[key], msg=key)
    t_model.eval()
    x = rng.normal(size=(8, width)).astype(np.float32)
    _close(t_model(torch.from_numpy(x)).detach(), j_model.apply(variables, x, train=False))


@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_wta_losses_match_jax(beta):
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(4), size=8).astype(np.float32)[..., None]
    hyp2 = np.concatenate([rng.normal(size=(8, 4, 2)).astype(np.float32), probs], -1)
    hyp3 = np.concatenate([rng.normal(size=(8, 4, 3)).astype(np.float32) + [2.5, 0, 0],
                           probs], -1).astype(np.float32)
    y2 = rng.normal(size=(8, 2)).astype(np.float32)
    y3 = (rng.normal(size=(8, 3)) + [0, 2.5, 0]).astype(np.float32)
    cases = ((lambda h, y: jmod.wta_with_scoring_l2_loss(h, y, beta),
              lambda h, y: tmod.wta_with_scoring_l2_loss(h, y, beta), hyp2, y2),
             (lambda h, y: jmod.wta_with_scoring_l2_loss_v2(h, y, beta, 2.0, 1.0),
              lambda h, y: tmod.wta_with_scoring_l2_loss_v2(h, y, beta, 2.0, 1.0), hyp3, y3))
    for j_fn, t_fn, hyp, y in cases:
        want, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(hyp), jnp.asarray(y))
        h = torch.from_numpy(hyp).requires_grad_(True)
        got = t_fn(h, torch.from_numpy(y))
        got.backward()
        assert abs(got.item() - float(want)) <= TOL * abs(float(want))
        _close(h.grad, j_grad)
        for mode in ("weighted_ave", "best_score"):
            _close(tmod.aggregate_toy_hypotheses(torch.from_numpy(hyp), mode),
                   jmod.aggregate_toy_hypotheses(jnp.asarray(hyp), mode))


def _diffusion_pair():
    j_model = jdiff.LiftingDiffusionModel(hidden_features=16, n_layers=2, num_steps=8,
                                          n_samples=3)
    x = np.random.default_rng(4).normal(size=(6, 1)).astype(np.float32)
    y = np.random.default_rng(5).normal(size=(6, 2)).astype(np.float32)
    variables = _np(j_model.init({"params": jax.random.PRNGKey(0),
                                  "diffusion": jax.random.PRNGKey(1)}, x, y, False))
    t_model = tdiff.LiftingDiffusionModel(1, 16, 2, 8, n_samples=3)
    t_model.load_state_dict(toy_state_dict_from_jax(variables), strict=True)
    return j_model, t_model, variables, x, y


def test_diffusion_schedules_match_jax():
    for schedule in ("quad", "linear", "cosine"):
        for a, b in zip(tdiff.compute_noise_scheduling(schedule, 1e-4, 0.5, 50),
                        jdiff.compute_noise_scheduling(schedule, 1e-4, 0.5, 50)):
            np.testing.assert_array_equal(a, b)


def _recording(monkeypatch, name):
    """Record what ``jax.random.<name>`` returns (run without jit, so the
    values are concrete)."""
    drawn, fn = [], getattr(jax.random, name)

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, name, record)
    return drawn


def test_diffusion_loss_and_sampling_match_jax_with_its_noise(monkeypatch):
    """calc_loss (train mode, updating BatchNorm) and sample_hypotheses with
    the steps and noise the JAX package draws, recorded and given to the
    port."""
    j_model, t_model, variables, x, y = _diffusion_pair()
    steps, noise = _recording(monkeypatch, "randint"), _recording(monkeypatch, "normal")
    with jax.disable_jit():
        loss, updates = j_model.apply(variables, x, y, True,
                                      rngs={"diffusion": jax.random.PRNGKey(9)},
                                      method=j_model.calc_loss, mutable=["batch_stats"])
    t_model.train()
    got = t_model.calc_loss(torch.from_numpy(x), torch.from_numpy(y),
                            t=torch.tensor(steps[0]).long(), noise=torch.tensor(noise[0]))
    assert abs(got.item() - float(loss)) <= TOL * float(loss)
    stats = toy_state_dict_from_jax({**variables, **_np(updates)})
    for k, v in t_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, stats[k], msg=k)

    variables = {**variables, **_np(updates)}
    noise.clear()
    with jax.disable_jit():
        want = j_model.apply(variables, x, rngs={"diffusion": jax.random.PRNGKey(10)},
                             method=j_model.sample_hypotheses)
    assert len(noise) == 9  # the start and one draw a step
    t_model.train()  # sampling runs the denoiser on its running statistics anyway
    got = t_model.sample_hypotheses(torch.from_numpy(x),
                                    noise=torch.tensor(np.stack(noise)))
    assert t_model.training
    _close(got, want)


def _toy_overrides(scenario, arch, out_dir):
    base = [f"data.scenario={scenario}", "data.n_train=200", "data.n_val=100",
            "data.n_test=100", "train.epochs=2", "train.batch_size=100",
            f"run.output_dir={out_dir}", "diffusion.num_steps=10"]
    if arch == "diffusion":
        return base + ["diffusion.enabled=true", "model.arch=mlp"]
    return base + [f"model.arch={arch}"]


def _metrics(path: Path) -> dict:
    rows = (line.split(": ") for line in path.read_text().splitlines())
    return {k: float(v) for k, v in rows}


RUNS = [("easy", "mlp"), ("hard-1", "constrained"), ("hard-2", "constrained_rmcl"),
        ("hard-4", "mlp"), ("torus-2Dto3D", "mlp"), ("torus-2Dto3D", "constrained"),
        ("torus-2Dto3D", "constrained_rmcl"), ("hard-2", "diffusion")]


@pytest.mark.parametrize("scenario,arch", RUNS)
def test_toy_main_runs_on_the_cpu_and_matches_jax(tmp_path, scenario, arch):
    """``toy.main`` with device=cpu at 2 epochs: the loss history, metrics
    and saved predictions. Every model but the diffusion baseline (whose
    noise streams cannot match) starts from the JAX package's init and
    matches its main's loss history and metrics."""
    overrides = _toy_overrides(scenario, arch, tmp_path / "port") + ["device=cpu"]
    cfg = load_config("toy", overrides)
    state_dict = None
    if arch != "diffusion":
        j_cfg = j_load_config("toy", _toy_overrides(scenario, arch, tmp_path / "jax"))
        enabled_3d = "3D" in scenario
        data = (jmain.LiftingDatasetV2 if enabled_3d else jmain.LiftingDataset)(
            jmain.build_distribution(j_cfg), 200, 100, 100)
        model, _, _ = jmain.build_model(j_cfg, enabled_3d)
        variables = model.init({"params": jax.random.PRNGKey(j_cfg.run.seed)},
                               data.x_train[:2], train=False)
        state_dict = toy_state_dict_from_jax(_np(variables))
        jmain.main(j_cfg)
    val = tmain.main(cfg, state_dict=state_dict)
    run = tmp_path / "port" / "default"
    losses, metrics = np.load(run / "train_loss.npy"), _metrics(run / "metrics.txt")
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert all(np.isfinite(v) for v in metrics.values()) and val == metrics["val_mpjpe"]
    assert (run / "test_predictions.npy").exists()
    assert (run / "test_hypotheses.npy").exists() == (arch in ("constrained_rmcl",
                                                               "diffusion"))
    if arch == "diffusion":
        return
    j_run = tmp_path / "jax" / "default"
    tol = RUN_TOL_CANCELLING.get((scenario, arch), RUN_TOL)
    np.testing.assert_allclose(losses, np.load(j_run / "train_loss.npy"), rtol=tol)
    want = _metrics(j_run / "metrics.txt")
    assert set(metrics) == set(want)
    for k, v in want.items():
        assert abs(metrics[k] - v) <= tol * max(abs(v), 1e-3), k


def test_toy_main_refuses_plots_and_3d_diffusion(tmp_path):
    """run.plots=true draws the JAX main's two figures (valid PNGs beside
    the metrics); the 3D diffusion baseline is refused, as in the JAX
    package."""
    cfg = load_config("toy", _toy_overrides("easy", "mlp", tmp_path) + [
        "device=cpu", "run.plots=true", "train.epochs=1"])
    tmain.main(cfg)
    assert (tmp_path / "default" / "metrics.txt").exists()
    for name in ("predictions_plot.png", "training.png"):
        assert (tmp_path / "default" / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(NotImplementedError, match="circle"):
        tmain.main(load_config("toy", _toy_overrides("torus-2Dto3D", "diffusion", tmp_path)
                               + ["device=cpu"]))
