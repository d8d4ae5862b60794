"""PyTorch port vs the JAX package on the joint-major layout
(``model.layout=joint_major``): MixSTE and the rMCL manifold model against
the JAX package's joint-major models on the same weights (forward and
gradients), the port's joint-major layout against its fold layout on the
same weights (eval, and train mode with drop-path masks from one
generator seed), the plain joint-major attention against the JAX einsum,
and the refusal of attn_impl values that JAX refuses with joint-major.

Everything runs in fp32 on the CPU with inputs made by numpy from a seed;
the JAX side takes its XLA attention, the only one it runs joint-major.

Tolerances: forward 5e-5 of max(1, |out|max) (the JAX package's
model-forward tolerance); gradients 5e-4 * max(1, |g|max) per tensor (its
MLP-gradient tolerance); the port's two layouts 1e-6 of max(1, |out|max)
(the same products, their sums regrouped)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.models as jm
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.ops.attention import joint_major_attention as j_joint_major_attention
from manipose_tpu_torch import models as tm
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.models.mix_ste import DropPath, set_drop_path_generator
from manipose_tpu_torch.ops.attention import joint_major_attention, multi_head_attention
from manipose_tpu_torch.weights import state_dict_from_jax

TOL, GRAD_TOL, LAYOUT_TOL = 5e-5, 5e-4, 1e-6
TRUNK = dict(num_frame=9, embed_dim=32, depth=2, num_heads=4)
MANIFOLD = dict(num_frame=9, embed_dim_rot=32, depth_rot=2, num_heads_rot=4,
                embed_dim_seg=16, depth_seg=2, num_heads_seg=4, n_hyp=2)


def _jax_model(arch, layout, drop_path_rate=0.0):
    if arch == "mixste":
        return jm.MixSTE(jm.MixSTEConfig(layout=layout, drop_path_rate=drop_path_rate,
                                         **TRUNK))
    return jm.RMCLManifoldMixSTE(
        jm.ManifoldConfig(layout=layout, drop_path_rate=drop_path_rate, **MANIFOLD),
        j_skeleton())


def _port_model(arch, layout, drop_path_rate=0.0, remat=False):
    if arch == "mixste":
        return tm.MixSTE(tm.MixSTEConfig(layout=layout, drop_path_rate=drop_path_rate,
                                         remat=remat, **TRUNK))
    return tm.RMCLManifoldMixSTE(
        tm.ManifoldConfig(layout=layout, drop_path_rate=drop_path_rate, remat=remat,
                          **MANIFOLD), t_skeleton())


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """Joint-major params with every leaf perturbed (zero biases, positional
    tables and LayerNorm affines all carry signal)."""
    x = jnp.zeros((1, 9, 17, 2), jnp.float32)
    params = jax.jit(_jax_model(arch, "joint_major").init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)


def _input(seed=1, b=2):
    return np.random.default_rng(seed).normal(size=(b, 9, 17, 2)).astype(np.float32)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _cotangents(outs, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]


def _jax_forward_and_grads(arch, x):
    model, params = _jax_model(arch, "joint_major"), _jax_params(arch)
    outs = _outputs(jax.jit(model.apply)(params, jnp.asarray(x)))
    cots = _cotangents(outs)

    def objective(p):
        return sum(jnp.sum(o * c) for o, c in zip(_outputs(model.apply(p, x)), cots))

    grads = jax.jit(jax.grad(objective))(params)
    arch_name = "mixste" if arch == "mixste" else "rmcl_manifold"
    return ([np.asarray(o) for o in outs], cots,
            state_dict_from_jax(jax.device_get(grads), arch_name))


@pytest.mark.parametrize("arch", ["mixste", "rmcl_manifold"])
def test_joint_major_matches_jax(arch):
    """The port's joint-major model against the JAX package's on the same
    weights: every output, and the gradient of a fixed random projection of
    them with respect to every parameter."""
    x = _input()
    want, cots, want_grads = _jax_forward_and_grads(arch, x)
    model = _port_model(arch, "joint_major")
    model.load_state_dict(state_dict_from_jax(_jax_params(arch),
                                              "mixste" if arch == "mixste"
                                              else "rmcl_manifold"), strict=True)
    model.eval()
    got = _outputs(model(torch.from_numpy(x)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() <= TOL * max(1.0, np.abs(w).max())
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    for name, p in model.named_parameters():
        w = want_grads[name]
        tol = GRAD_TOL * max(1.0, w.abs().max().item())
        assert (p.grad - w).abs().max().item() <= tol, name


def _record_masks(monkeypatch):
    """Every drop-path mask drawn, flattened, in draw order."""
    masks = []
    draw = DropPath.draw

    def recording(self, x):
        mask = draw(self, x)
        if mask is not None:
            masks.append(mask.flatten().clone())
        return mask

    monkeypatch.setattr(DropPath, "draw", recording)
    return masks


@pytest.mark.parametrize("arch", ["mixste", "rmcl_manifold"])
def test_joint_major_equals_fold_in_the_port(arch, monkeypatch):
    """Joint-major against fold on the same weights: the eval forward, and
    a train-mode forward with drop-path on (rate 0.5) from one generator
    seed, whose masks come out identical (per (b, l) in spatial blocks, per
    (b, j) in temporal ones) and whose outputs and gradients agree."""
    fold = _port_model(arch, "fold", drop_path_rate=0.5)
    joint = _port_model(arch, "joint_major", drop_path_rate=0.5)
    joint.load_state_dict(fold.state_dict())
    x = torch.from_numpy(_input(seed=3))
    fold.eval(), joint.eval()
    for a, b in zip(_outputs(joint(x)), _outputs(fold(x))):
        assert (a - b).abs().max().item() <= LAYOUT_TOL * max(1.0, b.abs().max().item())
    runs = []
    for model in (fold, joint):
        masks = _record_masks(monkeypatch)
        model.train()
        set_drop_path_generator(model, torch.Generator().manual_seed(7))
        outs = _outputs(model(x))
        sum(o.square().sum() for o in outs).backward()
        runs.append((outs, masks, {n: p.grad for n, p in model.named_parameters()}))
        monkeypatch.undo()
    (f_outs, f_masks, f_grads), (j_outs, j_masks, j_grads) = runs
    assert len(f_masks) == len(j_masks) > 0
    assert any(not m.all() for m in f_masks)  # some rows were dropped
    for a, b in zip(j_masks, f_masks):
        assert torch.equal(a, b)
    for a, b in zip(j_outs, f_outs):
        assert (a - b).abs().max().item() <= LAYOUT_TOL * max(1.0, b.abs().max().item())
    for name, g in f_grads.items():
        assert (j_grads[name] - g).abs().max().item() <= GRAD_TOL * max(
            1.0, g.abs().max().item()), name


def test_joint_major_attention_matches_jax():
    """The plain joint-major attention against the JAX einsum, and the
    port's attention entry on a (B, J, L, 3*h*d) qkv tensor (the path the
    model takes; on the CPU its plain version over strided views) against
    it."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 17, 5, 4, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_joint_major_attention(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), 0.35))
    got = joint_major_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), 0.35)
    assert got.shape == (2, 17, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    qkv = torch.from_numpy(np.stack([q, k, v], axis=3).reshape(2, 17, 5, 96))
    np.testing.assert_allclose(multi_head_attention(qkv, 4, 0.35).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "xla_direct", "pallas", "pallas_temporal"])
def test_attn_impl_refusal_matches_jax(impl):
    """A joint-major config with attn_impl=impl is refused by the port
    (ValueError) exactly when the JAX package refuses it (its assertion
    while the model is set up)."""
    j_model = jm.MixSTE(jm.MixSTEConfig(layout="joint_major", attn_impl=impl, **TRUNK))
    try:
        jax.eval_shape(j_model.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 9, 17, 2), jnp.float32))
        jax_refuses = False
    except AssertionError:
        jax_refuses = True
    try:
        tm.MixSTE(tm.MixSTEConfig(layout="joint_major", attn_impl=impl, **TRUNK))
        port_refuses = False
    except ValueError:
        port_refuses = True
    assert port_refuses == jax_refuses == (impl == "pallas")
