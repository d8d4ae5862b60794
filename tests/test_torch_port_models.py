"""PyTorch port vs the JAX package: MixSTE, the manifold model and the rMCL
model with the same weights (the JAX side running its Pallas attention in
interpret mode), weight conversion, the model factory and aggregation."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.models as jm
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.train.checkpoint import convert_to_torch_state_dict
from manipose_tpu_torch import models as tm
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.weights import load_torch_checkpoint, state_dict_from_jax

# the JAX package's model-forward tolerance, at unit output scale: fp32
# rounding grows with the outputs' magnitude (the muP readout doubles them)
TOL = 5e-5
# the sizes of tests/test_serving.py
TRUNK = dict(num_frame=9, embed_dim=32, depth=2, num_heads=4, drop_path_rate=0.0)
MANIFOLD = dict(num_frame=9, embed_dim_rot=32, depth_rot=2, num_heads_rot=4,
                embed_dim_seg=16, depth_seg=2, num_heads_seg=4, n_hyp=2,
                drop_path_rate=0.0)
OVERRIDES = [
    "data.seq_len=9",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2",
]


def _jax_model(arch, mup=False, attn_impl="pallas"):
    if arch == "mixste":
        return jm.MixSTE(jm.MixSTEConfig(attn_impl=attn_impl, mup=mup, **TRUNK))
    cfg = jm.ManifoldConfig(attn_impl=attn_impl, mup=mup, **MANIFOLD)
    cls = jm.ManifoldMixSTE if arch == "manifold" else jm.RMCLManifoldMixSTE
    return cls(cfg, j_skeleton())


def _port_model(arch, mup=False):
    if arch == "mixste":
        return tm.MixSTE(tm.MixSTEConfig(mup=mup, **TRUNK))
    cfg = tm.ManifoldConfig(mup=mup, **MANIFOLD)
    cls = tm.ManifoldMixSTE if arch == "manifold" else tm.RMCLManifoldMixSTE
    return cls(cfg, t_skeleton())


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed):
    """Init (through the XLA twin: same parameter tree, faster on the CPU),
    then perturb every leaf so that zero-initialized biases, positional
    tables and LayerNorm affines all carry signal."""
    x = jnp.zeros((1, 9, 17, 2), jnp.float32)
    params = jax.jit(_jax_model(arch, attn_impl="xla").init)(
        jax.random.PRNGKey(seed), x
    )
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )


def _pair(arch, mup=False, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, 9, 17, 2)).astype(np.float32)
    j_model = _jax_model(arch, mup)
    params = _jax_params(arch, seed)
    t_model = _port_model(arch, mup)
    t_model.load_state_dict(state_dict_from_jax(params, arch), strict=True)
    return x, j_model, params, t_model.eval()


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("arch,mup", [("mixste", False), ("mixste", True),
                                      ("manifold", False),
                                      ("rmcl_manifold", False),
                                      ("rmcl_manifold", True)])
def test_forward_matches_jax(arch, mup):
    x, j_model, params, t_model = _pair(arch, mup)
    want = _outputs(jax.jit(j_model.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _outputs(t_model(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        w = np.asarray(w)
        atol = TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0)


@pytest.mark.parametrize("arch", ["mixste", "manifold", "rmcl_manifold"])
def test_state_dict_from_jax_matches_converter(arch):
    params = _jax_params(arch, 0)
    ref = convert_to_torch_state_dict(params, arch)
    got = state_dict_from_jax(params, arch)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("arch", ["mixste", "manifold", "rmcl_manifold"])
def test_factory_builds_reference_names(arch):
    cfg = load_config("config", OVERRIDES + [f"model.arch={arch}"])
    model, rmcl = instantiate_model(cfg, t_skeleton())
    assert rmcl == (arch == "rmcl_manifold")
    params = _jax_params(arch, 0)
    model.load_state_dict(state_dict_from_jax(params, arch), strict=True)


def test_factory_init_is_seeded():
    cfg = load_config("config", OVERRIDES)
    a = instantiate_model(cfg, t_skeleton())[0].state_dict()
    b = instantiate_model(cfg, t_skeleton())[0].state_dict()
    c = instantiate_model(
        load_config("config", OVERRIDES + ["run.seed=7"]), t_skeleton()
    )[0].state_dict()
    w = "rotations_module.STEblocks.0.attn.qkv.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[w], c[w])
    bound = 1 / np.sqrt(32)
    assert a[w].abs().max() <= bound and a[w].abs().max() > 0.5 * bound
    assert a["rotations_module.STEblocks.0.attn.qkv.bias"].abs().max() > 0


@pytest.mark.parametrize("override", ["model.attn_impl=ring",
                                      "model.layout=joint_major",
                                      "model.dtype=bfloat16"])
def test_factory_refuses_unported_settings(override):
    cfg = load_config("config", OVERRIDES + [override])
    with pytest.raises(NotImplementedError):
        instantiate_model(cfg, t_skeleton())


def test_factory_ignores_jax_kernel_knobs():
    cfg = load_config("config", OVERRIDES + ["model.attn_impl=pallas",
                                             "model.mlp_impl=pallas"])
    model, _ = instantiate_model(cfg, t_skeleton())
    ref = instantiate_model(load_config("config", OVERRIDES), t_skeleton())[0]
    assert all(torch.equal(v, ref.state_dict()[k])
               for k, v in model.state_dict().items())


def test_reference_pth_loads_strict(tmp_path):
    """A reference checkpoint ({'model_pos': ...} with DataParallel's
    'module.' prefixes) loads as is."""
    cfg = load_config("config", OVERRIDES)
    model, _ = instantiate_model(cfg, t_skeleton())
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    path = tmp_path / "manipose.pth"
    torch.save({"model_pos": sd, "epoch": 3}, path)
    other = instantiate_model(
        load_config("config", OVERRIDES + ["run.seed=9"]), t_skeleton()
    )[0]
    other.load_state_dict(load_torch_checkpoint(path), strict=True)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in other.state_dict().items())


@pytest.mark.parametrize("mode", ["weighted_ave", "best_score"])
def test_aggregation_matches_jax(mode):
    rng = np.random.default_rng(3)
    hyps = rng.normal(size=(2, 3, 5, 17, 3)).astype(np.float32)
    logits = rng.normal(size=(2, 3, 5, 1)).astype(np.float32)
    scores = np.array(jax.nn.softmax(jnp.asarray(logits), axis=1))
    want = jm.aggregate_hypotheses(jnp.asarray(hyps), jnp.asarray(scores), mode)
    got = tm.aggregate_hypotheses(torch.from_numpy(hyps),
                                  torch.from_numpy(scores), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_oracle_aggregation_waits_for_training_slice():
    """Oracle aggregation came with the training slice's WTA loss: the
    winner's MPJPE and poses, as in the JAX package."""
    rng = np.random.default_rng(4)
    hyps = rng.normal(size=(2, 3, 5, 17, 3)).astype(np.float32)
    gt = rng.normal(size=(2, 5, 17, 3)).astype(np.float32)
    want_err, want_poses = jm.aggregate_hypotheses(
        jnp.asarray(hyps), None, "oracle", jnp.asarray(gt))
    got_err, got_poses = tm.aggregate_hypotheses(
        torch.from_numpy(hyps), None, "oracle", torch.from_numpy(gt))
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_poses.numpy(), np.asarray(want_poses))
    with pytest.raises(ValueError, match="Ground truth"):
        tm.aggregate_hypotheses(torch.from_numpy(hyps), None, "oracle")
