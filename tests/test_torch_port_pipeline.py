"""PyTorch port vs the JAX package on GPipe pipelining
(``parallel/pipeline.py`` and ``parallel/flagship.py``).

One world of 4 gloo CPU ranks (``tests/torch_ranks.py``) runs the port:
``pipeline_apply`` of tanh-MLP stages over a 1 x 4 pipe mesh at 4, 8 and 16
microbatches against the stages applied one after another; the rMCL
flagship (depth 4) through ``make_pipelined_apply`` on data 2 x pipe 2 with
2 microbatches, forward and gradients (the tied post-block norms, the
stage-0 embedding and temporal table, the replicated head and segments
branch) against the JAX ``make_pipelined_apply`` and ``model.apply`` here
on the 8 virtual CPU devices; two fsdp_dp steps on that mesh against one
process, which ranks hold which blocks, and that state's checkpoint
round trip; drop-path in training; MixSTE with its head and the manifold
model on the 1 x 4 mesh. Tolerances of ``tests/test_pipeline.py``: poses
1e-4, scores 1e-5, gradients 5e-5, the MixSTE output 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.models as jm
import manipose_tpu.train as jt
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.parallel import make_mesh as j_make_mesh
from manipose_tpu.parallel.flagship import make_pipelined_apply as j_pipelined
from manipose_tpu.parallel.flagship import pick_microbatches as j_pick
from manipose_tpu_torch.parallel import flagship
from manipose_tpu_torch.weights import state_dict_from_jax
from torch_ranks import run_ranks

J_SKEL = j_skeleton()
CFG = dict(num_frame=9, embed_dim_rot=32, depth_rot=4, num_heads_rot=4, embed_dim_seg=16,
           depth_seg=2, num_heads_seg=4, n_hyp=2, drop_path_rate=0.0)
MIX_CFG = dict(num_frame=9, embed_dim=32, depth=4, num_heads=4, drop_path_rate=0.0)
S, MLP_B, MLP_C = 4, 16, 8


def _init(model, x, seed):
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), x[:1]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_world")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 9, 17, 2)).astype(np.float32)
    y = rng.normal(size=(8, 9, 17, 3)).astype(np.float32)
    mix_x = rng.normal(size=(4, 9, 17, 2)).astype(np.float32)
    mlp = {"w": (rng.normal(size=(S, MLP_C, MLP_C)) / np.sqrt(MLP_C)).astype(np.float32),
           "b": (rng.normal(size=(S, MLP_C)) * 0.1).astype(np.float32)}
    mlp_x = rng.normal(size=(MLP_B, MLP_C)).astype(np.float32)
    rmcl = jm.RMCLManifoldMixSTE(jm.ManifoldConfig(**CFG), J_SKEL)
    manifold = jm.ManifoldMixSTE(jm.ManifoldConfig(**CFG), J_SKEL)
    mix = jm.MixSTE(jm.MixSTEConfig(**MIX_CFG))
    params = _init(rmcl, jnp.asarray(x), 0)
    manifold_params = _init(manifold, jnp.asarray(x), 1)
    mix_params = _init(mix, jnp.asarray(mix_x), 2)
    t = torch.from_numpy
    torch.save({
        "cfg": CFG, "weights": state_dict_from_jax(params, "rmcl_manifold"),
        "x": t(x), "y": t(y), "mlp": {k: t(v) for k, v in mlp.items()}, "mlp_x": t(mlp_x),
        "mixste_cfg": MIX_CFG, "mixste_weights": state_dict_from_jax(mix_params, "mixste"),
        "mixste_x": t(mix_x),
        "manifold_weights": state_dict_from_jax(manifold_params, "manifold"),
    }, out / "inputs.pt")
    run_ranks(4, "pipeline", out, timeout=420)
    return dict(x=x, y=y, mix_x=mix_x, mlp=mlp, mlp_x=mlp_x, rmcl=rmcl, params=params,
                manifold=manifold, manifold_params=manifold_params, mix=mix,
                mix_params=mix_params,
                got=torch.load(out / "results.pt", weights_only=False))


def _stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("microbatches", [4, 8, 16])
def test_pipeline_apply_matches_sequential_stages(world, microbatches):
    params = {k: jnp.asarray(v) for k, v in world["mlp"].items()}

    def sequential(params, x):
        for s in range(S):
            x = _stage(jax.tree_util.tree_map(lambda p: p[s], params), x)
        return x

    x = jnp.asarray(world["mlp_x"])
    want = jax.jit(sequential)(params, x)
    want_gp, want_gx = jax.jit(jax.grad(lambda p, x: jnp.sum(sequential(p, x) ** 2),
                                        argnums=(0, 1)))(params, x)
    out, gx, gp = world["got"][f"mlp_{microbatches}"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), atol=1e-5)
    for k in params:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(want_gp[k]), atol=1e-5)


def test_pipelined_flagship_forward_matches_jax(world):
    mesh = j_make_mesh(data=2, pipe=2)
    apply_fn = j_pipelined(world["rmcl"], mesh, data_axis="data", microbatches=2)
    x = jnp.asarray(world["x"])
    p1, s1 = jax.jit(world["rmcl"].apply)(world["params"], x)
    with mesh:
        p2, s2 = jax.jit(lambda p, x: apply_fn(p, x, deterministic=True))(
            world["params"], x)
    got_p, got_s = world["got"]["rmcl_forward"]
    for want_p, want_s in ((p1, s1), (p2, s2)):
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


def test_pipelined_flagship_gradients_match_jax(world):
    """Every parameter, the tied norms included: summed over pipe for the
    trunk, averaged over data, whole on every rank."""
    model, params = world["rmcl"], world["params"]
    x, y = jnp.asarray(world["x"]), jnp.asarray(world["y"])
    grads = jax.jit(jax.grad(lambda p: jt.compute_loss(
        model.apply(p, x, deterministic=True), y, jt.LossConfig(rmcl=True), J_SKEL)[0]))(
        params)
    want = state_dict_from_jax(jax.device_get(grads), "rmcl_manifold")
    got = world["got"]["rmcl_grads"]
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=5e-5, err_msg=name)
    assert float(got["rotations_module.Spatial_norm.weight"].abs().max()) > 0


def test_pipelined_fsdp_dp_steps_match_one_process(world):
    got, want = world["got"]["fsdp_dp_params"]
    assert set(got) == set(want)
    for name, w in want.items():  # Adam's first steps: lr * sign(g) at noise level
        assert float((got[name] - w).abs().max()) <= 2 * 1e-3 * 2 + 1e-6, name


def test_pipe_ranks_hold_their_stage_blocks_only(world):
    """As the JAX version keeps 1/S of the stacked blocks on each device,
    each rank of the data 2 x pipe 2 mesh holds the two blocks of its stage
    (the others are empty placeholders), fewer elements than the model."""
    trunk_blocks = CFG["depth_rot"] // 2
    per_rank = world["got"]["stages"]
    assert len(per_rank) == 4
    for stage, ste, tte, _ in per_rank:
        want = list(range(stage * trunk_blocks, (stage + 1) * trunk_blocks))
        assert ste == want and tte == want
    whole = sum(v.size for v in jax.tree_util.tree_leaves(world["params"]))
    assert all(numel < whole for *_, numel in per_rank)


def test_pipelined_checkpoint_resumes_in_the_single_device_layout(world):
    """The pipelined fsdp_dp train state, saved and restored: the same
    weights and Adam moments, the optimizer state laid out as the
    one-process optimizer's, and the same loss on the next step."""
    got = world["got"]["pipe_resume"]
    assert got["same_state"] and got["single_device_optimizer"]
    np.testing.assert_allclose(got["losses"][1], got["losses"][0], rtol=1e-6)


def test_pipelined_training_with_drop_path_is_finite(world):
    assert np.isfinite(world["got"]["drop_path_losses"]).all()


def test_pipelined_mixste_and_manifold_match_jax(world):
    want = jax.jit(world["mix"].apply)(world["mix_params"], jnp.asarray(world["mix_x"]))
    np.testing.assert_allclose(world["got"]["mixste"].numpy(), np.asarray(want), atol=1e-5)
    want = jax.jit(world["manifold"].apply)(world["manifold_params"],
                                            jnp.asarray(world["x"]))
    np.testing.assert_allclose(world["got"]["manifold"].numpy(), np.asarray(want),
                               atol=1e-4)


def test_pick_microbatches_clamps_as_jax():
    for args in ((16, 2, 4), (4, 2, 4), (6, 2, 4), (2, 2, 8), (243, 1, 4)):
        assert flagship.pick_microbatches(*args) == j_pick(*args)
    with pytest.raises(ValueError):
        flagship.pick_microbatches(5, 2, 4)
