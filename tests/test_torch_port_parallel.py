"""PyTorch port vs the JAX package on ``parallel/``: the parameter rules,
the multi-process launch, ring attention, and the rMCL train step and
eval forward under every ``shard_params`` mode.

The port runs one process a device: a world of 4 gloo CPU ranks
(``tests/torch_ranks.py``, one start for the whole file) runs every
multi-rank check from the same seeded weights and batch, and the JAX
references run here on the 8 virtual CPU devices (``tests/conftest.py``).
Tolerances are the JAX package's own (``tests/test_parallel.py``): ring
attention 2e-6 forward and 5e-6 gradients; train-step losses 1e-5
relative (1e-4 at the second step) and first-step gradients 1e-4 absolute;
the eval forward 2e-4 (poses) and 1e-5 (scores).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import manipose_tpu.models as jm
import manipose_tpu.train as jt
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.parallel import RingSpec as JRingSpec
from manipose_tpu.parallel import fsdp_param_spec as j_fsdp_spec
from manipose_tpu.parallel import make_mesh as j_make_mesh
from manipose_tpu.parallel import param_spec as j_param_spec
from manipose_tpu.parallel import ring_attention as j_ring
from manipose_tpu_torch import parallel as tp
from manipose_tpu_torch.parallel import mesh as tmesh
from manipose_tpu_torch.parallel import multihost
from manipose_tpu_torch.weights import state_dict_from_jax
from torch_ranks import run_ranks

J_SKEL = j_skeleton()
CFG = dict(num_frame=9, embed_dim_rot=32, depth_rot=2, num_heads_rot=4, embed_dim_seg=16,
           depth_seg=2, num_heads_seg=4, n_hyp=2, drop_path_rate=0.0)
RING_NS = (6, 10, 32, 243)
MODES = ("tp", "dp", "fsdp_dp", "fsdp")
LR = 1e-3


def _jax_params(model, x, seed=0):
    """Initial params with every leaf perturbed (each carries signal)."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), x[:1])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _batch(b=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 9, 17, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(b, 9, 17, 3))).astype(np.float32)
    return x, y


def _ring_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 2, n, 8)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references and the results of one 4-rank run of the port."""
    out = tmp_path_factory.mktemp("parallel_world")
    model = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(**CFG), J_SKEL)
    x, y = _batch()
    params = _jax_params(model, jnp.asarray(x))
    ring = {n: _ring_inputs(n, seed) for seed, n in enumerate(RING_NS)}
    torch.save({
        "cfg": CFG, "weights": state_dict_from_jax(params, "rmcl_manifold"),
        "x": torch.from_numpy(x), "y": torch.from_numpy(y),
        "ring": {n: [torch.from_numpy(t) for t in ts] for n, ts in ring.items()},
    }, out / "inputs.pt")
    run_ranks(4, "parallel", out, timeout=420)
    return dict(model=model, params=params, x=x, y=y, ring=ring,
                got=torch.load(out / "results.pt", weights_only=False))


# ---- the parameter rules -------------------------------------------------

def _torch_names(params):
    """{torch name: (JAX path, JAX shape)} for the trunk and segments
    parameters, whose map to the port's names is one to one (each leaf is
    marked with its index and carried through the weight map)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(leaves)])
    out = {}
    for name, t in state_dict_from_jax(marked, "rmcl_manifold").items():
        path, leaf = leaves[int(t.reshape(-1)[0])]
        if sorted(np.shape(leaf)) == sorted(t.shape):
            out[name] = (jax.tree_util.keystr(path, simple=True, separator="/"),
                         np.shape(leaf))
    return out


def _as_torch_spec(spec, jax_shape, linear):
    """A JAX spec with one entry per dim, in torch's dim order (a Linear
    weight is the flax kernel transposed)."""
    spec = tuple(spec) + (None,) * (len(jax_shape) - len(tuple(spec)))
    return spec[::-1] if linear else spec


def test_param_specs_follow_the_jax_rules():
    model = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(**CFG), J_SKEL)
    params = _jax_params(model, jnp.zeros((1, 9, 17, 2), jnp.float32))
    names = _torch_names(params)
    assert any("attn.qkv.weight" in n for n in names)
    checked = 0
    for name, (path, shape) in names.items():
        linear = len(shape) == 2 and name.endswith(".weight")
        torch_shape = shape[::-1] if linear else shape
        got = tp.param_spec(name)
        got = tuple(got) + (None,) * (len(torch_shape) - len(got))
        assert got == _as_torch_spec(j_param_spec(path), shape, linear), (name, path)
        for data_size in (2, 4, 8):
            for use_tp in (True, False):
                got = tp.fsdp_param_spec(name, torch_shape, data_size, use_tp=use_tp)
                want = _as_torch_spec(j_fsdp_spec(path, shape, data_size, use_tp=use_tp),
                                      shape, linear)
                assert got == want, (name, path, data_size, use_tp)
                checked += 1
    assert checked > 100
    # the rules of tests/test_parallel.py:40-46 on the port's names
    assert tp.param_spec("x.attn.qkv.weight") == ("model", None)
    assert tp.param_spec("x.attn.proj.weight") == (None, "model")
    assert tp.param_spec("x.mlp.fc1.bias") == ("model",)
    assert tp.param_spec("x.norm1.weight") == ()
    assert tp.param_spec("Spatial_pos_embed") == ()
    assert j_param_spec("x/attn/qkv/kernel") == P(None, "model")


def test_parallel_exports_the_jax_names():
    import manipose_tpu.parallel as jpar

    assert sorted(tp.__all__) == sorted(jpar.__all__)
    assert all(hasattr(tp, name) for name in tp.__all__)


# ---- the multi-process launch --------------------------------------------

_LAUNCH_VARS = ("MANIPOSE_MULTIHOST", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def test_initialize_follows_the_jax_rules(monkeypatch):
    """tests/test_multihost.py:30-62 on the port: a no-op without a launch,
    a partial specification raises, auto (or MANIPOSE_MULTIHOST=1) reads the
    launcher's environment, explicit arguments win."""
    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert tp.initialize_multihost() is False and calls == []
    assert tp.is_primary() is True
    with pytest.raises(ValueError, match="partially specified"):
        tp.initialize_multihost(coordinator_address="host:1234")
    assert tp.initialize_multihost(auto=True, backend="gloo") is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]
    calls.clear()
    monkeypatch.setenv("MANIPOSE_MULTIHOST", "1")
    assert tp.initialize_multihost(backend="gloo") is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]
    calls.clear()
    assert tp.initialize_multihost("127.0.0.1:29999", 2, 1, backend="gloo") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://127.0.0.1:29999",
                      "world_size": 2, "rank": 1}]


def test_a_world_that_is_not_there_names_the_launch(monkeypatch):
    from manipose_tpu_torch.config import load_config

    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for extra in (["parallel.data=2"], ["parallel.pipe=2"], ["parallel.model=2"]):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            multihost.require_world(load_config("config", extra), "cpu")
        with pytest.raises(ValueError, match="torchrun"):
            tmesh.make_mesh(data=2)
    assert multihost.require_world(load_config("config", []), "cpu") == 1
    with pytest.raises(ValueError, match="cannot share a mesh"):
        tmesh.make_mesh(data=1, model=2, pipe=2)


# ---- ring attention ------------------------------------------------------

def _dense(q, k, v, scale):
    p = jax.nn.softmax(jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale, -1)
    return jnp.einsum("bhnm,bhmd->bhnd", p, v)


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("n", RING_NS)
def test_ring_attention_matches_jax(world, ring, n):
    q, k, v = (jnp.asarray(t) for t in world["ring"][n])
    scale = 8 ** -0.5
    mesh = j_make_mesh(data=8 // ring, model=ring)

    def loss(q, k, v):
        out = j_ring(q, k, v, scale, mesh, "model")
        return jnp.sum(out ** 2), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                       has_aux=True))(q, k, v)
    out, *grads = world["got"][f"ring{ring}_{n}"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(_dense)(q, k, v, scale)),
                               atol=2e-6)
    for name, got, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-6,
                                   err_msg=f"d{name}")


# ---- the train step and eval forward under every mode --------------------

@pytest.fixture(scope="module")
def single_device(world):
    """The JAX single-device train step (two steps) and gradients."""
    model, params = world["model"], world["params"]
    x, y = jnp.asarray(world["x"]), jnp.asarray(world["y"])
    tx = jt.make_optimizer(weight_decay=1e-6)
    step = jt.make_train_step(model.apply, jt.LossConfig(rmcl=True), J_SKEL, tx,
                              donate=False)
    state = jt.TrainState.create(params, tx, jax.random.PRNGKey(1))
    state, m1 = step(state, x, y, LR)
    state, m2 = step(state, x, y, LR)
    grads = jax.jit(jax.grad(lambda p: jt.compute_loss(
        model.apply(p, x, deterministic=True), y, jt.LossConfig(rmcl=True), J_SKEL)[0]))(
        params)
    poses, scores = jax.jit(model.apply)(params, x)
    return dict(losses=(float(m1["loss"]), float(m2["loss"])),
                grads=state_dict_from_jax(jax.device_get(grads), "rmcl_manifold"),
                poses=np.asarray(poses), scores=np.asarray(scores))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_train_step_matches_jax(world, single_device, mode):
    """data 2 x model 2: the loss of two steps and the first step's
    gradients, each gathered into the single-device layout."""
    got = world["got"][mode]
    want = single_device
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"][1], want["losses"][1], rtol=1e-4)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), atol=1e-4,
                                   err_msg=name)
    assert {k: tuple(v.shape) for k, v in got["params"].items()} == \
        {k: tuple(v.shape) for k, v in want["grads"].items()}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_eval_forward_matches_jax(world, single_device, mode):
    got = world["got"][mode]
    np.testing.assert_allclose(got["poses"].numpy(), single_device["poses"], atol=2e-4)
    np.testing.assert_allclose(got["scores"].numpy(), single_device["scores"], atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_train_state_resumes(world, mode):
    """A resume state saved under the mode (gathered into the single-device
    layout, written by rank 0) and restored into a fresh sharded model and
    optimizer: the same weights, Adam moments, generator and step count,
    and the next step's loss."""
    got = world["got"][mode]["resume"]
    assert got["same_state"]
    assert got["losses"][0] == got["losses"][1]


@pytest.mark.parametrize("mode", MODES)
def test_clipping_uses_the_global_norm_over_the_shards(world, mode):
    want = world["got"]["clip_plain"]
    got = world["got"][f"clip_{mode}"]
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)


def test_ring_trunk_model_matches_jax(world):
    """attn_impl=ring: the whole rMCL model with ring temporal attention on
    data 2 x model 2 against the JAX model's single-device apply and its own
    ring mesh (tests/test_parallel.py:326-352)."""
    mesh = j_make_mesh(data=2, model=2)
    model = world["model"]
    ring_model = jm.RMCLManifoldMixSTE(dataclasses.replace(
        model.cfg, attn_impl="ring", ring=JRingSpec(mesh=mesh, axis="model",
                                                    batch_axis="data")), J_SKEL)
    x = jnp.asarray(world["x"])
    p1, s1 = jax.jit(model.apply)(world["params"], x)
    with mesh:
        p2, s2 = jax.jit(lambda p, x: ring_model.apply(p, x, deterministic=True))(
            world["params"], x)
    got_p, got_s = world["got"]["ring_model"]
    for want_p, want_s in ((p1, s1), (p2, s2)):
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-4)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


def test_launch_helpers_in_a_world_of_four(world):
    got = world["got"]["multihost"]
    assert got["shape"] == {"data": 2, "model": 2}
    assert got["primary"] is True and got["data_index"] == 0
    # each rank fed its own shard: the data ranks 0 and 2 in data order
    np.testing.assert_array_equal(got["rows"].numpy(), [0.0, 0.0, 2.0, 2.0])
