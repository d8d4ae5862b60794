"""The port's muP tools, ``seg_heads_ab`` and the ``model=fast`` preset
against the JAX package's, on the CPU.

- ``utils.jax_random`` and ``train.init.flax_init_from_key``: JAX's bits
  and keys equal, its truncated normal and the JAX MixSTE's flax init
  within 1e-6 (float32 rounding of erfinv), so that the port's muP tools
  start from the JAX tools' weights for a seed.
- ``mup_coord_check``: the port's ``run`` against the JAX tool's loop,
  width 32 under muP and 64 without, 3 steps, from the port's own init and
  from the JAX weights (``state_dict_from_jax``): every row within 1e-4
  relative. The JAX side is the tool's ``run`` line for line with its
  model applies, its gradient and its optimizer update compiled as one
  step (the tool runs them eagerly, 20 s a width on the CPU).
- ``mup_lr_transfer``: ``lr_transfer`` at widths 32 and 64, 2 learning
  rates, 3 steps, one seed, from the port's own init, against the JAX
  tool's ``lr_transfer`` over the tool's ``sweep_width`` rebuilt line for
  line: the curves within 1e-4 relative, the same best rates, the gap
  within 1e-4.
- ``seg_heads_ab``: ``make_split`` against the split rebuilt from the JAX
  ``tools/synthetic_overfit.make_videos`` (``tools/h36m_head_to_head.py``
  imports ``tests/conftest.py`` as a module of its own, so it stays out of
  this process): the same videos within float32 FK rounding (1e-5 m); then
  the CLI at the protocol scale, one seed and one epoch an arm: both arms
  finite, each built with its own ``num_heads_seg``, the JSON written.
- ``model=fast``: the port's config equals the JAX package's, and the
  small model's forward matches the JAX one from the same weights within
  5e-5 of max(1, |ref|max), the JAX package's model tolerance.

The JAX functions are compiled at XLA's lowest optimization level
(``_compiled``), which shortens the compiles (4 s to 0.7 s for a step) and
leaves the results within 1e-5 of the default's.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
from manipose_tpu.models import MixSTE as JMixSTE
from manipose_tpu.models import MixSTEConfig as JMixSTEConfig
from manipose_tpu.train import make_optimizer as j_make_optimizer
from manipose_tpu.train.mup import make_mup_optimizer as j_make_mup_optimizer
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.tools import mup_coord_check, mup_lr_transfer, seg_heads_ab
from manipose_tpu_torch.utils import jax_random
from manipose_tpu_torch.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
ROW_TOL = 1e-4
MODEL_TOL = 5e-5
FK_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: under the suite's workers its intra-op threads
    only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` at XLA's lowest
    optimization level."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


def _mixste_init(width, seq_len, base_width, mup, key, x):
    cfg = JMixSTEConfig(num_frame=seq_len, num_joints=17, embed_dim=width, depth=2,
                        num_heads=4, mup=mup, mup_base_width=base_width, drop_path_rate=0.0)
    model = JMixSTE(cfg)
    rng = jax.random.PRNGKey(key)
    return cfg, model, _compiled(model.init, rng, x)(rng, x)


def _close(got, want, tol, what):
    assert abs(got - want) <= tol * max(abs(want), 1e-12), (what, got, want)


# ---- mup_coord_check ---------------------------------------------------------

def _jax_coord_rows(width, base_width, steps, mup):
    """``tools/mup_coord_check.run`` with one jitted step."""
    L, J = mup_coord_check.L, mup_coord_check.J
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(8, L, J, 2)).astype(np.float32))
    cfg, model, params = _mixste_init(width, L, base_width, mup, 1, x)
    trunk = JMixSTE(cfg, apply_head=False)
    tx = (j_make_mup_optimizer(params, width=width, base_width=base_width, weight_decay=0.0)
          if mup else j_make_optimizer(weight_decay=0.0))
    opt_state = tx.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(1e-2)

    def step(params, opt_state):
        feats = trunk.apply(params, x)
        out = model.apply(params, x)
        grads = jax.grad(lambda p: jnp.mean((model.apply(p, x) - 1.0) ** 2))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (jnp.mean(jnp.abs(feats)), jnp.mean(jnp.abs(out)),
                optax.apply_updates(params, updates), opt_state)

    rows = []
    params0 = jax.tree_util.tree_map(np.asarray, params)
    step = _compiled(step, params, opt_state)
    for i in range(steps):
        trunk_abs, out_abs, params, opt_state = step(params, opt_state)
        rows.append({"step": i, "width": width, "trunk_abs": float(trunk_abs),
                     "out_abs": float(out_abs)})
    return params0, rows


def test_jax_random_streams_equal_jax():
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(jax_random.prng_key(7), np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(jax_random.fold_in(jax_random.prng_key(7), 2**31 + 5),
                                  np.asarray(jax.random.key_data(
                                      jax.random.fold_in(key, 2**31 + 5))))
    np.testing.assert_array_equal(jax_random.random_bits(jax_random.prng_key(7), (3, 5)),
                                  np.asarray(jax.random.bits(key, (3, 5))))
    np.testing.assert_allclose(jax_random.truncated_normal(jax_random.prng_key(7), -2, 2,
                                                           (64, 96)),
                               np.asarray(jax.random.truncated_normal(key, -2, 2, (64, 96))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("width,mup", [(32, True), (64, False)])
def test_mup_coord_check_rows_match_jax(width, mup):
    """The port's init is the JAX tool's within float32 rounding; its rows
    from that init and from the JAX weights both match the JAX rows."""
    params, want = _jax_coord_rows(width, 32, 3, mup)
    jax_weights = state_dict_from_jax(params, "mixste")
    own = mup_coord_check.build_model(width, 32, mup).state_dict()
    assert set(own) == set(jax_weights)
    for name, w in jax_weights.items():
        np.testing.assert_allclose(own[name].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for state_dict in (None, jax_weights):
        got = mup_coord_check.run(width, 32, 3, mup=mup, state_dict=state_dict,
                                  device="cpu")
        assert [(r["step"], r["width"]) for r in got] == [(r["step"], r["width"])
                                                          for r in want]
        for g, w in zip(got, want):
            for key in ("trunk_abs", "out_abs"):
                _close(g[key], w[key], ROW_TOL, (width, mup, g["step"], key))


def test_mup_coord_check_cli_prints_rows(capsys):
    rows = mup_coord_check.main(["--widths", "32", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["width", "step", "trunk|a|", "out|a|"]
    assert [line.split()[:2] for line in out[1:]] == [["32", "0"], ["32", "1"]]
    assert all(np.isfinite([r["trunk_abs"], r["out_abs"]]).all() for r in rows)


# ---- mup_lr_transfer ----------------------------------------------------------

def _jax_sweep_width(width, lrs, steps=20, base_width=32, depth=2, seq_len=9, mup=True,
                     seed=0):
    """``tools/mup_lr_transfer.sweep_width`` (the scan of Adam steps from
    the seed's init, once per learning rate), compiled by ``_compiled``."""
    assert depth == 2
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(16, seq_len, 17, 2)).astype(np.float32))
    xn = np.asarray(x)
    y = jnp.asarray(np.stack([np.tanh(xn[..., 0] * 2.0), xn[..., 0] * xn[..., 1],
                              np.abs(xn[..., 1]) - 0.5], axis=-1).astype(np.float32))
    _, model, params0 = _mixste_init(width, seq_len, base_width, mup, seed, x)

    def loss_fn(p):
        return jnp.mean((model.apply(p, x) - y) ** 2)

    def run(params, lr):
        tx = (j_make_mup_optimizer(params, width=width, base_width=base_width,
                                   weight_decay=0.0) if mup
              else j_make_optimizer(weight_decay=0.0))
        opt_state = tx.init(params)
        opt_state.hyperparams["learning_rate"] = lr

        def body(carry, _):
            params, opt_state = carry
            updates, opt_state = tx.update(jax.grad(loss_fn)(params), opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), None

        (params, _), _ = jax.lax.scan(body, (params, opt_state), None, length=steps)
        return loss_fn(params)

    lr0 = jnp.asarray(lrs[0], jnp.float32)
    run = _compiled(run, params0, lr0)
    return [float(run(params0, jnp.asarray(lr, jnp.float32))) for lr in lrs]


def test_lr_transfer_matches_jax(monkeypatch):
    """The JAX tool's ``lr_transfer`` over its sweep against the port's
    plain loop, each from its own init of the seed."""
    jl = _jax_tool("mup_lr_transfer")
    monkeypatch.setattr(jl, "sweep_width", _jax_sweep_width)
    lrs, widths, steps, seeds = [1e-3, 3e-2], (32, 64), 3, (0,)
    want = jl.lr_transfer(widths=widths, lrs=lrs, steps=steps, mup=True, seeds=seeds)
    got = mup_lr_transfer.lr_transfer(widths=widths, lrs=lrs, steps=steps, mup=True,
                                      seeds=seeds, device="cpu")
    assert got["lrs"] == want["lrs"] and got["best_idx"] == want["best_idx"]
    for w in widths:
        for g, v in zip(got["curves"][w], want["curves"][w]):
            _close(g, v, ROW_TOL, ("curve", w))
    assert abs(got["transfer_gap"] - want["transfer_gap"]) <= ROW_TOL


def test_lr_transfer_sweep_data_equals_jax():
    """The inputs and targets of the JAX tool's ``sweep_width``, rebuilt
    from its source."""
    x, y = mup_lr_transfer.sweep_data(9, 1)
    xn = np.random.default_rng(1).normal(size=(16, 9, 17, 2)).astype(np.float32)
    yn = np.stack([np.tanh(xn[..., 0] * 2.0), xn[..., 0] * xn[..., 1],
                   np.abs(xn[..., 1]) - 0.5], axis=-1).astype(np.float32)
    np.testing.assert_array_equal(x, xn)
    np.testing.assert_array_equal(y, yn)


# ---- seg_heads_ab -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2])
def test_make_split_equals_jax(seed):
    videos = _jax_tool("synthetic_overfit").make_videos(
        n_videos=8, n_frames=8 * 27, skel=j_skeleton(), seed=1000 + seed)
    want = ((videos[0][:6], videos[1][:6]), (videos[0][6:], videos[1][6:]))
    got = seg_heads_ab.make_split(seed)
    for g_split, w_split in zip(got, want):
        for g_part, w_part in zip(g_split, w_split):
            assert len(g_part) == len(w_part)
            for g, w in zip(g_part, w_part):
                np.testing.assert_allclose(g, w, atol=FK_TOL, rtol=0)


def test_seg_heads_ab_one_epoch_per_arm(tmp_path, monkeypatch, capsys):
    """The CLI at the protocol scale (d=64, L=27, segments 16 wide, K=3):
    one seed, one epoch an arm; each arm's model has its head split."""
    from manipose_tpu_torch.drivers import common

    built = []

    original = common.instantiate_model

    def spy(cfg, skel, **kw):
        model, rmcl = original(cfg, skel, **kw)
        built.append((model.cfg.num_heads_seg, model.cfg.embed_dim_seg, model.cfg.num_frame))
        return model, rmcl

    monkeypatch.setattr(common, "instantiate_model", spy)
    out = tmp_path / "ab" / "seg_heads_ab.json"
    results = seg_heads_ab.main(["--seeds", "0", "--epochs", "1", "--json", str(out),
                                 "--device", "cpu"])
    assert built == [(8, 16, 27), (2, 16, 27)]
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert results["protocol"]["arms"] == {"seg8": 8, "seg2": 2}
    for arm in ("seg8", "seg2"):
        (row,) = results[arm]
        assert set(row) == {"best_val_mpjpe", "final_mpjpe", "mpsce", "mpsse"}
        assert np.isfinite(list(row.values())).all(), (arm, row)
    text = capsys.readouterr().out
    assert "=== seed 0: seg8 ===" in text and "=== seed 0: seg2 ===" in text
    assert f"wrote {out}" in text


def test_seg_heads_ab_default_json_is_not_the_jax_artifact():
    """The JAX tool writes tools/artifacts/seg_heads_ab.json; the port's
    default lands in the working directory."""
    args = seg_heads_ab.parser().parse_args([])
    assert args.json == Path("seg_heads_ab.json") and args.device == "cuda"
    assert (args.seeds, args.epochs, args.heads_a, args.heads_b) == ([0, 1, 2], 10, 8, 2)


# ---- model=fast ---------------------------------------------------------------

SMALL = ["data.seq_len=9", "model.layers=2", "model.channels=32", "model.nheads=4",
         "model.layers_seg=2", "model.channels_seg=16", "multi_hyp.n_hyp=2",
         "model.drop_path_rate=0.0"]


def test_fast_preset_config_equals_jax():
    got, want = load_config("config", ["model=fast"]), j_load_config("config", ["model=fast"])
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got.model.nheads_seg == 2 and got.model.channels_seg == 128
    assert got.model.channels_seg // got.model.nheads_seg == 64
    plain = load_config("config")
    assert {k for k in plain.model if plain.model[k] != got.model[k]} == {"nheads_seg"}


def test_fast_preset_forward_matches_jax():
    cfg = load_config("config", ["model=fast", *SMALL])
    j_cfg = j_load_config("config", ["model=fast", *SMALL])
    j_model, _ = j_instantiate(j_cfg, j_skeleton())
    key, x0 = jax.random.PRNGKey(0), jnp.zeros((1, 9, 17, 2))
    params = jax.tree_util.tree_map(np.asarray, _compiled(j_model.init, key, x0)(key, x0))
    model, rmcl = instantiate_model(cfg, h36m_skeleton_17())
    assert rmcl and model.cfg.num_heads_seg == 2
    model.load_state_dict(state_dict_from_jax(params, "rmcl_manifold"), strict=True)
    model.eval()
    x = np.random.default_rng(0).normal(size=(2, 9, 17, 2)).astype(np.float32)
    want = _compiled(j_model.apply, params, jnp.asarray(x))(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=MODEL_TOL * max(1.0, float(np.abs(w).max())))
