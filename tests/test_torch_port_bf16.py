"""bf16 compute (``model.dtype=bfloat16``: fp32 parameters, bf16
activations): the port against the JAX package in bf16, on the CPU.

The JAX side runs ``attn_impl=pallas, mlp_impl=pallas`` (Pallas in
interpret mode), since the port's plain MLP keeps GELU's input in fp32 as
the fused kernel does; the row counts here (B=2 windows of L=16 frames:
544 rows over 17 joints, 512 over 16 bones) are ones the fused Pallas MLP
takes (``pallas_mlp.supported``). Weights are the JAX init perturbed by
0.05 noise, inputs numpy normals from a seed.

Tolerances:
- each module (MixSTE, the rotations and segments branches, the FK
  decoder on the same bf16 inputs), ``predict_video`` of MixSTE and the
  rMCL scores: 0.05 * max(1, |ref|max), the JAX package's bf16 model
  tolerance (tests/test_pallas_mlp.py);
- the manifold models' poses: the decoder's Gram-Schmidt is ill
  conditioned at random weights (nearly parallel 6D vectors), so bf16
  itself moves the JAX package's poses by more than 0.05 of their
  magnitude at these weights (its bf16 against its fp32; the forward test
  prints the gap). The composed model is held at the same 0.05, or at
  2 * that gap + 1e-3 where the gap is larger; each module it composes is
  held at 0.05 on its own;
- loss terms: 0.05 relative;
- gradients of both branches' outputs under a fixed random cotangent
  (every kernel's backward, the trunks and the heads, without FK and the
  WTA loss): 0.05 relative in norm per tensor;
- gradients of the loss: for each parameter tensor with a non-negligible
  gradient,
  e_port = |g_port,bf16 - g_jax,bf16| / |g_jax,bf16| must not pass
  2 * e_jax + 1e-3, where e_jax = |g_jax,bf16 - g_jax,fp32| / |g_jax,fp32|
  is the gap bf16 opens in the JAX package (norms over the tensor). The
  rMCL heads' gradients follow each position's WTA winner, which bf16
  noise flips where two heads nearly tie, and a head with few wins then
  differs from JAX bf16 by more than the rule allows although both are
  as close to fp32. The MCL heads' tensors are therefore held against the
  fp32 gradient by the same bound (|g_port,bf16 - g_jax,fp32| /
  |g_jax,fp32| <= 2 e_jax + 1e-3: the port in bf16 no further from fp32
  than twice the JAX package in bf16);
- train steps at the flagship's learning rate, 4e-5 (configs/config.yaml):
  metrics 0.05 relative on every step, parameters after n Adam steps
  within 2 * lr * n, as in the fp32 step test. (At the fp32 test's 1e-3,
  two Adam steps move this small model so far that the noise of bf16
  gradients separates two runs by more than the tolerance.)
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.models as jm
from manipose_tpu.models.rmcl import RMCLRotMixSTE as JRMCLRot
import manipose_tpu.train as jt
from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.eval.engine import flip_poses as j_flip
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.models.decoder import decode_poses as j_decode
from manipose_tpu.models.manifold import BonesMixSTE as JBones
from manipose_tpu.serving import Predictor as JPredictor
from manipose_tpu_torch import models as tm
from manipose_tpu_torch import train as tt
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.eval.engine import flip_poses
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.models.decoder import decode_poses
from manipose_tpu_torch.models.mix_ste import DropPath, set_drop_path_generator
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.weights import state_dict_from_jax

J_SKEL, T_SKEL = j_skeleton(), t_skeleton()
BF16_TOL = 0.05
GRAD_SLACK = 1e-3
LR = 4e-5
B, L, J = 2, 16, 17
TRUNK = dict(num_frame=L, embed_dim=64, depth=2, num_heads=8, drop_path_rate=0.0)
MANIFOLD = dict(num_frame=L, embed_dim_rot=64, depth_rot=2, num_heads_rot=8,
                embed_dim_seg=32, depth_seg=1, num_heads_seg=4, n_hyp=3,
                drop_path_rate=0.0)
OVERRIDES = [
    f"data.seq_len={L}",
    "model.layers=2", "model.channels=64", "model.nheads=8",
    "model.layers_seg=1", "model.channels_seg=32", "model.nheads_seg=4",
    "multi_hyp.n_hyp=3", "model.drop_path_rate=0.0",
]
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_model(arch, dtype):
    """The JAX model in ``dtype``: bf16 on the Pallas kernels, fp32 on XLA
    (the fp32 side is only the bf16 gap's reference)."""
    impl = "pallas" if dtype == "bfloat16" else "xla"
    kw = dict(attn_impl=impl, mlp_impl=impl, dtype=J_DTYPES[dtype])
    if arch == "mixste":
        return jm.MixSTE(jm.MixSTEConfig(**kw, **TRUNK))
    cfg = jm.ManifoldConfig(**kw, **MANIFOLD)
    cls = jm.ManifoldMixSTE if arch == "manifold" else jm.RMCLManifoldMixSTE
    return cls(cfg, J_SKEL)


def _port_model(arch, dtype="bfloat16"):
    kw = dict(dtype=T_DTYPES[dtype])
    if arch == "mixste":
        model = tm.MixSTE(tm.MixSTEConfig(**kw, **TRUNK))
    else:
        cfg = tm.ManifoldConfig(**kw, **MANIFOLD)
        cls = tm.ManifoldMixSTE if arch == "manifold" else tm.RMCLManifoldMixSTE
        model = cls(cfg, T_SKEL)
    model.load_state_dict(state_dict_from_jax(_params(arch), arch), strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _params(arch):
    x = jnp.zeros((1, L, J, 2), jnp.float32)
    params = jax.jit(_jax_model(arch, "float32").init)(jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params,
    )


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, J, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(b, L, J, 3))).astype(np.float32)
    return x, y


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_max_err(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, dtype):
    x, _ = _inputs()
    return _tuple(jax.jit(_jax_model(arch, dtype).apply)(_params(arch), jnp.asarray(x)))


# ---- forward -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixste", "manifold", "rmcl_manifold"])
def test_bf16_forward_matches_jax(arch):
    """Whole models: the output dtypes of the JAX package (bf16 poses for
    MixSTE and the manifold model, fp32 poses and scores for rMCL) and the
    values within the bf16 tolerance (see the module docstring)."""
    x, _ = _inputs()
    want, want32 = _jax_forward(arch, "bfloat16"), _jax_forward(arch, "float32")
    with torch.no_grad():
        got = _tuple(_port_model(arch).eval()(torch.from_numpy(x)))
    assert len(got) == len(want)
    for g, w, w32 in zip(got, want, want32):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        gap = _rel_max_err(w, w32)
        tol = max(BF16_TOL, 2 * gap + GRAD_SLACK) if arch != "mixste" else BF16_TOL
        print(f"{arch} {w.dtype} output: port vs JAX bf16 {_rel_max_err(g, w):.4f}, "
              f"JAX bf16 vs fp32 {gap:.4f}, tol {tol:.4f}")
        assert _rel_max_err(g, w) <= tol, (arch, _rel_max_err(g, w), gap)


def _branches(arch, x, port):
    """(rotations-branch outputs, segments-branch output) of the bf16 model
    on ``x``: the port's modules, or the JAX package's on its params."""
    if port:
        model = _port_model(arch).eval()
        with torch.no_grad():
            xt = torch.from_numpy(x)
            return _tuple(model.rotations_module(xt)), model.segments_module(xt)
    cfg = jm.ManifoldConfig(attn_impl="pallas", mlp_impl="pallas",
                            dtype=jnp.bfloat16, **MANIFOLD)
    p = _params(arch)["params"]
    rot = (JRMCLRot(cfg) if arch == "rmcl_manifold"
           else jm.MixSTE(cfg.rot_trunk_config()))
    rot_out = jax.jit(rot.apply)({"params": p["rotations_module"]}, jnp.asarray(x))
    seg_out = jax.jit(JBones(cfg).apply)({"params": p["segments_module"]},
                                         jnp.asarray(x))
    return _tuple(rot_out), seg_out


@pytest.mark.parametrize("arch", ["manifold", "rmcl_manifold"])
def test_bf16_branches_and_decoder_match_jax(arch):
    """Each module of the manifold models on its own, at 0.05: the
    rotations branch (6D rotations; for rMCL also the scores), the
    segments branch (bone lengths) and the FK decoder on the JAX package's
    bf16 rotations and lengths."""
    x, _ = _inputs()
    (rot, *rest), seg = _branches(arch, x, port=False)
    (t_rot, *t_rest), t_seg = _branches(arch, x, port=True)
    for g, w in [(t_rot, rot), (t_seg, seg)] + list(zip(t_rest, rest)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert _rel_max_err(g, w) <= BF16_TOL
    lengths = (seg[:, None, None, :, 0] if arch == "rmcl_manifold"
               else jnp.swapaxes(seg, 1, 2))
    roots = jnp.zeros(rot.shape[:-2] + (3,), rot.dtype)
    want = j_decode(rot, lengths, roots, J_SKEL, 6)
    t_rot_in = torch.from_numpy(_f32(rot)).to(T_DTYPES[str(rot.dtype)])
    t_len_in = torch.from_numpy(_f32(lengths)).to(T_DTYPES[str(lengths.dtype)])
    got = decode_poses(t_rot_in, t_len_in, t_rot_in.new_zeros(roots.shape), T_SKEL, 6)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert _rel_max_err(got, want) <= BF16_TOL


def _cotangents(outs):
    rng = np.random.default_rng(11)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]


@functools.lru_cache(maxsize=None)
def _jax_branch_grads(arch, dtype):
    """The JAX package's gradients of both branches' outputs under a fixed
    random cotangent, in ``dtype``, in the port's names."""
    x, _ = _inputs(seed=4)
    impl = "pallas" if dtype == "bfloat16" else "xla"
    cfg = jm.ManifoldConfig(attn_impl=impl, mlp_impl=impl, dtype=J_DTYPES[dtype], **MANIFOLD)
    rot = JRMCLRot(cfg) if arch == "rmcl_manifold" else jm.MixSTE(cfg.rot_trunk_config())
    seg = JBones(cfg)
    p = _params(arch)["params"]

    def outs(rp, sp):
        return list(_tuple(rot.apply({"params": rp}, jnp.asarray(x)))) + [
            seg.apply({"params": sp}, jnp.asarray(x))]

    cots = _cotangents(outs(p["rotations_module"], p["segments_module"]))

    def total(rp, sp):
        return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(outs(rp, sp), cots))

    g_rot, g_seg = jax.jit(jax.grad(total, argnums=(0, 1)))(
        p["rotations_module"], p["segments_module"])
    tree = {"params": {"rotations_module": g_rot, "segments_module": g_seg}}
    return state_dict_from_jax(jax.device_get(tree), arch), cots


@pytest.mark.parametrize("arch", ["manifold", "rmcl_manifold"])
def test_bf16_branch_gradients_match_jax(arch):
    """Each parameter's gradient of both branches' outputs under a fixed
    random cotangent, in bf16, against the JAX package's: the backward of
    every trunk layer and head, well conditioned (a 1e-3 change of the
    input moves these by under 1 % on the CPU, while it moves the loss's
    gradients through FK by half at random weights). Within 0.05 relative in
    norm, or 2 * e_jax + 1e-3 where bf16 moves the JAX package's own
    gradient further (here some attention biases of the segments trunk)."""
    want, cots = _jax_branch_grads(arch, "bfloat16")
    want32, _ = _jax_branch_grads(arch, "float32")
    x, _ = _inputs(seed=4)
    model = _port_model(arch).train()
    xt = torch.from_numpy(x)
    outs = list(_tuple(model.rotations_module(xt))) + [model.segments_module(xt)]
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    worst = 0.0
    for name, g in model.named_parameters():
        assert g.grad.dtype == torch.float32, name
        err = (g.grad - want[name]).norm().item() / want[name].norm().item()
        e_jax = (want[name] - want32[name]).norm().item() / want32[name].norm().item()
        tol = max(BF16_TOL, 2 * e_jax + GRAD_SLACK)
        assert err <= tol, (name, err, e_jax)
        worst = max(worst, err / tol)
    print(f"worst branch-gradient err / tol over {arch}'s tensors: {worst:.3f}")


def test_drop_path_and_flip_keep_the_dtype():
    """DropPath scales the kept rows of a bf16 activation in bf16, as the
    JAX ``where(keep, x / keep_prob, 0)``; the TTA flip keeps its input's
    dtype."""
    x = torch.randn(32, 5, 8).bfloat16()
    layer = DropPath(0.3).train()
    set_drop_path_generator(layer, torch.Generator().manual_seed(1))
    out = layer(x)
    assert out.dtype == torch.bfloat16
    kept = out[:, 0, 0] != 0
    assert torch.equal(out[kept], (x[kept] / 0.7))
    poses = np.random.default_rng(5).normal(size=(2, L, J, 3)).astype(np.float32)
    want = j_flip(jnp.asarray(poses, jnp.bfloat16), J_SKEL)
    got = flip_poses(torch.from_numpy(poses).bfloat16(), T_SKEL)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("arch", ["mixste", "rmcl_manifold"])
def test_bf16_predict_video_matches_jax(arch):
    """``predict_video`` under model.dtype=bfloat16 with TTA, over two
    windows and a padded tail: MixSTE's bf16 poses come back as float32
    arrays holding the bf16 values, as the JAX Predictor's bf16 arrays
    widen; rMCL's poses, hypotheses and scores are fp32 on both sides."""
    overrides = OVERRIDES + [f"model.arch={arch}", "model.dtype=bfloat16"]
    j_pred = JPredictor(
        cfg=j_load_config("config", overrides + ["model.attn_impl=pallas",
                                                 "model.mlp_impl=pallas"]),
        variables=_params(arch), batch_size=B, tta=True,
    )
    t_pred = Predictor(cfg=load_config("config", overrides), batch_size=B, tta=True,
                       state_dict=state_dict_from_jax(_params(arch), arch),
                       device="cpu")
    video = np.random.default_rng(7).normal(size=(L + 5, J, 2)).astype(np.float32)
    want = j_pred.predict_video(video, return_hypotheses=True)
    got = t_pred.predict_video(video, return_hypotheses=True)
    assert got[0].dtype == np.float32 and got[0].shape == (L + 5, J, 3)
    if arch == "mixste":
        assert str(want[0].dtype) == "bfloat16" and got[1] is None
        np.testing.assert_array_equal(got[0], _f32(torch.from_numpy(got[0]).bfloat16()))
        assert _rel_max_err(got[0], want[0]) <= BF16_TOL
        return
    j32 = JPredictor(cfg=j_load_config("config", OVERRIDES), variables=_params(arch),
                     batch_size=B, tta=True).predict_video(video, return_hypotheses=True)
    for g, w, w32 in zip(got, want, j32):
        assert g.dtype == w.dtype == np.float32
        tol = max(BF16_TOL, 2 * _rel_max_err(w, w32) + GRAD_SLACK)
        assert _rel_max_err(g, w) <= tol
    assert _rel_max_err(got[2], want[2]) <= BF16_TOL  # the scores
    np.testing.assert_allclose(got[2].sum(axis=1), 1.0, atol=1e-5)


# ---- loss, gradients, train steps ---------------------------------------

def _loss_cfg(arch, module):
    return module.LossConfig(rmcl=arch == "rmcl_manifold")


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, dtype):
    model = _jax_model(arch, dtype)
    x, y = _inputs(seed=3)

    def total(p):
        return jt.compute_loss(model.apply(p, jnp.asarray(x)), jnp.asarray(y),
                               _loss_cfg(arch, jt), J_SKEL)

    (_, terms), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(_params(arch))
    return terms, state_dict_from_jax(jax.device_get(grads), arch)


def _check_grads(grads, arch):
    """The gradient rule of the module docstring, per parameter tensor;
    returns the worst e_port / (2 e_jax + slack)."""
    # the MCL heads: each position's gradient goes to its WTA winner
    def by_winner(name):
        return arch == "rmcl_manifold" and name.startswith("rotations_module.head.")

    _, want = _jax_loss_and_grads(arch, "bfloat16")
    _, want32 = _jax_loss_and_grads(arch, "float32")
    floor = 1e-6 * max(g.norm().item() for g in want32.values())
    worst = 0.0
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32, name
        g16, g32 = want[name], want32[name]
        if g32.norm().item() <= floor:
            continue
        ref = g32 if by_winner(name) else g16
        e_port = (g - ref).norm().item() / ref.norm().item()
        e_jax = (g16 - g32).norm().item() / g32.norm().item()
        bound = 2 * e_jax + GRAD_SLACK
        assert e_port <= bound, (name, e_port, e_jax)
        worst = max(worst, e_port / bound)
    print(f"worst e_port / (2 e_jax + {GRAD_SLACK}) over {arch}'s tensors: {worst:.3f}")
    return worst


@pytest.mark.parametrize("arch", ["manifold", "rmcl_manifold"])
def test_bf16_loss_and_gradients_match_jax(arch):
    """compute_loss on the bf16 model's outputs and its gradients with
    respect to the fp32 parameters: terms within 0.05 relative in the JAX
    package's dtypes, the total accumulated in fp32, gradients under the
    rule above."""
    want_terms, _ = _jax_loss_and_grads(arch, "bfloat16")
    model = _port_model(arch).train()
    x, y = _inputs(seed=3)
    total, terms = tt.compute_loss(model(torch.from_numpy(x)), torch.from_numpy(y),
                                   _loss_cfg(arch, tt), T_SKEL)
    assert total.dtype == torch.float32
    assert set(terms) == set(want_terms)
    for k, v in want_terms.items():
        assert str(terms[k].dtype).replace("torch.", "") == str(v.dtype), k
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=BF16_TOL, err_msg=k)
    total.backward()
    _check_grads({n: p.grad for n, p in model.named_parameters()}, arch)


def test_three_bf16_train_steps_match_jax():
    """Three rMCL train steps under model.dtype=bfloat16 against the JAX
    step: every metric within 0.05 relative on every step, the first step's
    gradients under the gradient rule, the parameters within 2 * lr * n."""
    arch = "rmcl_manifold"
    tx = jt.make_optimizer(weight_decay=1e-6)
    j_step = jt.make_train_step(_jax_model(arch, "bfloat16").apply, jt.LossConfig(),
                                J_SKEL, tx, donate=False)
    j_state = jt.TrainState.create(_params(arch), tx, jax.random.PRNGKey(1))
    model = _port_model(arch)
    opt = tt.make_optimizer(model.parameters(), weight_decay=1e-6)
    state = tt.TrainState.create(model, opt, seed=0, device="cpu")
    step = tt.make_train_step(model, tt.LossConfig(), T_SKEL, opt)
    first_grads = None
    for i in range(3):
        x, y = _inputs(seed=3) if i == 0 else _inputs(seed=10 + i)
        j_state, j_metrics = j_step(j_state, jnp.asarray(x), jnp.asarray(y), LR)
        if i == 0:  # the parameters' gradients before Adam moves them
            model.zero_grad()
            tt.compute_loss(model(torch.from_numpy(x)), torch.from_numpy(y),
                            tt.LossConfig(), T_SKEL)[0].backward()
            first_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        metrics = step(state, x, y, LR)
        assert set(metrics) == set(j_metrics)
        for k, v in j_metrics.items():
            assert metrics[k].dim() == 0 and metrics[k].dtype == torch.float32
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=BF16_TOL,
                                       err_msg=f"step {i} {k}")
    _check_grads(first_grads, arch)
    want = state_dict_from_jax(jax.device_get(j_state.params), arch)
    for name, p in model.state_dict().items():
        assert p.dtype == torch.float32
        assert (p - want[name]).abs().max().item() <= 2 * LR * 3 + 1e-6, name


@pytest.mark.parametrize("value", [None, "false", "true"])
def test_skip_nonfinite_is_read_from_the_config(value):
    """``train.skip_nonfinite`` (the bf16 guard) reaches the optimizer as
    the JAX train loop reads it; the default config leaves it off. With it
    on, a step whose gradients hold a NaN leaves the parameters alone."""
    overrides = OVERRIDES + ([] if value is None else [f"train.skip_nonfinite={value}"])
    cfg = load_config("config", overrides + ["model.dtype=bfloat16"])
    model = tm.MixSTE(tm.MixSTEConfig(dtype=torch.bfloat16, **TRUNK))
    opt = tt.optimizer_from_config(model, cfg)
    assert opt.skip_nonfinite == (value == "true")
    assert opt.grad_clip == float(cfg.train.grad_clip)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.full_like(p, float("nan"))
    assert opt.step(LR) == (value != "true")
    if value == "true":
        assert opt.notfinite_count == 1
        assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_bf16_loss_gradients_are_ill_conditioned_at_random_weights():
    """Why the card-vs-CPU checks of bf16 training (chip_smoke.py,
    tests/test_torch_port_cuda.py) hold the branches' gradients under a
    fixed cotangent closely and the loss's gradients only to be finite: at
    random weights, a 1e-3 change of the input moves the bf16 rMCL loss's
    gradients (through FK's Gram-Schmidt and the WTA loss) by a large part
    of their norm on the CPU, and the branches' gradients by under 2 %.
    The random weights are torch's init (``model.init=torch``), the port's
    only init when this was measured."""
    from manipose_tpu_torch.drivers import instantiate_model

    cfg = load_config("config", ["model=small", "model.layers=2", "model.layers_seg=1",
                                 "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
                                 "model.dtype=bfloat16", "model.init=torch"])
    weights = instantiate_model(cfg, T_SKEL)[0].state_dict()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 243, J, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(2, 243, J, 3))).astype(np.float32)

    def grads(x, branches):
        model, _ = instantiate_model(cfg, T_SKEL)
        model.load_state_dict(weights)
        xt = torch.from_numpy(x)
        if branches:
            outs = list(model.rotations_module(xt)) + [model.segments_module(xt)]
            gen = torch.Generator().manual_seed(0)
            total = sum((o.float() * torch.randn(o.shape, generator=gen)).sum() for o in outs)
        else:
            total = tt.compute_loss(model.train()(xt), torch.from_numpy(y), tt.LossConfig(),
                                    T_SKEL)[0]
        total.backward()
        return {n: p.grad for n, p in model.named_parameters()}

    moved = {}
    for branches in (False, True):
        a, b = grads(x, branches), grads(x * (1 + 1e-3), branches)
        moved[branches] = [((b[n] - g).norm() / g.norm()).item() for n, g in a.items()]
    print(f"median relative move of the gradients under a 1e-3 input change: loss "
          f"{np.median(moved[False]):.3f}, branches {np.median(moved[True]):.4f} "
          f"(worst {max(moved[True]):.4f})")
    assert np.median(moved[False]) > 0.1
    assert max(moved[True]) < 0.02
