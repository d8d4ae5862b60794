"""The port's evaluation path against the JAX package, on the CPU: the
metrics of ``metrics/{joint_errors,pck,consistency}.py``, the scoring
loss and ``concat_hyp_and_scores``, ``make_eval_step`` (TTA on and off,
rMCL on and off, the oracle, a padded row; fp32 and bf16),
``evaluate`` and ``run_test_protocol``'s whole table at a small config.

Weights are the JAX init perturbed by 0.05 noise, carried across with
``weights.state_dict_from_jax``; inputs are numpy normals from a seed.
The small config is ``tests/test_driver_h36m.py``'s: 2 layers of 32
channels and 4 heads, a segments trunk 16 wide with 4 heads, K = 2,
L = 9. The JAX side runs its default XLA attention in fp32 (the eval path
does not reach Pallas there) and Pallas in interpret mode in bf16, as
tests/test_torch_port_bf16.py does.

Tolerances:
- metrics: 1e-5 relative, or 1e-5 of the largest value for arrays (the
  same fp32 reductions in another order; the SVDs of two libraries);
- the eval step: 5e-5 of max(1, |ref|max), the JAX package's model
  tolerance, for poses, hypotheses, scores and the error sums (relative);
- the test protocol: 1e-4 of each table column's largest value (two eval
  runs and a few fp32 reductions over their outputs);
- bf16: the rule of tests/test_torch_port_bf16.py: FK-side outputs
  (predictions, hypotheses, oracle and pseudo-oracle poses) and the error
  sums within max(0.05, 2 * gap + 1e-3), gap being how far the JAX
  package's bf16 result lies from its fp32 one; scores within 0.05.
"""

import csv
import functools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import manipose_tpu.metrics as jmet
import manipose_tpu.models as jm
from manipose_tpu.config import load_config as j_load_config
from manipose_tpu.drivers.common import instantiate_model as j_instantiate
from manipose_tpu.drivers.h36m import (
    fetch_and_prepare_data as j_fetch_and_prepare,
    run_test_protocol as j_run_test_protocol,
)
from manipose_tpu.eval.engine import EvalConfig as JEvalConfig
from manipose_tpu.eval.engine import evaluate as j_evaluate
from manipose_tpu.eval.engine import make_eval_step as j_make_eval_step
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
import manipose_tpu_torch.metrics as tmet
from manipose_tpu_torch import models as tm
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.data import Batch
from manipose_tpu_torch.drivers.common import instantiate_model
from manipose_tpu_torch.drivers.h36m import (
    fetch_and_prepare_data,
    main,
    run_test_protocol,
)
from manipose_tpu_torch.eval.engine import EvalConfig, evaluate, make_eval_step
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton
from manipose_tpu_torch.utils.logging import MetricLogger
from manipose_tpu_torch.weights import state_dict_from_jax

J_SKEL, T_SKEL = j_skeleton(), t_skeleton()
L, J = 9, 17
OVERRIDES = [
    f"data.seq_len={L}",
    "model.layers=2", "model.channels=32", "model.nheads=4",
    "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
    "multi_hyp.n_hyp=2", "model.drop_path_rate=0.0",
]
METRIC_TOL = 1e-5
STEP_TOL = 5e-5
PROTOCOL_TOL = 1e-4
BF16_TOL, GAP_SLACK = 0.05, 1e-3


def _rel(got, want) -> float:
    """max |got - want| over max(1, |want|max)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    if not got.size:
        return 0.0
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _close(got, want, tol, what=""):
    err = _rel(got, want)
    assert err <= tol, (what, err, tol)


# ---- metrics ---------------------------------------------------------------

def _pose_pair(seed=0, n=4):
    """Predictions and targets (mm scale); the targets of half the samples
    are mirror images of rotated, scaled predictions, so that Procrustes
    meets a reflection (det(V U^T) < 0) there."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(scale=100.0, size=(n, L, J, 3)).astype(np.float32)
    tgt = (pred + rng.normal(scale=20.0, size=pred.shape)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    mirror = np.diag([-1.0, 1.0, 1.0]) @ q * 1.3
    tgt[: n // 2] = (pred[: n // 2] @ mirror.T.astype(np.float32)
                     + rng.normal(scale=5.0, size=pred[: n // 2].shape)).astype(np.float32)
    return pred, tgt


def _reflected_samples(pred, tgt) -> int:
    """How many (sample, frame) poses Procrustes must un-reflect."""
    x = tgt.reshape(-1, J, 3) - tgt.reshape(-1, J, 3).mean(1, keepdims=True)
    y = pred.reshape(-1, J, 3) - pred.reshape(-1, J, 3).mean(1, keepdims=True)
    u, _, vt = np.linalg.svd(np.einsum("nji,njk->nik", x, y))
    return int((np.linalg.det(vt.transpose(0, 2, 1) @ u.transpose(0, 2, 1)) < 0).sum())


FLAT_METRICS = ["mpjpe_error", "mse_error", "jointwise_error", "jointwise_mse",
                "coordwise_error"]


@pytest.mark.parametrize("mode", ["average", "sum", "no_agg"])
@pytest.mark.parametrize("name", FLAT_METRICS)
def test_joint_errors_match_jax(name, mode):
    pred, tgt = _pose_pair()
    want = getattr(jmet, name)(jnp.asarray(pred), jnp.asarray(tgt), mode)
    got = getattr(tmet, name)(torch.from_numpy(pred), torch.from_numpy(tgt), mode)
    _close(got, want, METRIC_TOL, name)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("mode", ["average", "no_agg"])
def test_segment_length_error_matches_jax(mode, signed):
    pred, tgt = _pose_pair(1)
    want = jmet.segments_len_err(jnp.asarray(pred), jnp.asarray(tgt), J_SKEL, mode, signed)
    got = tmet.segments_len_err(torch.from_numpy(pred), torch.from_numpy(tgt), T_SKEL,
                                mode, signed)
    _close(got, want, METRIC_TOL)


def test_p_mpjpe_matches_jax_with_reflections():
    """P-MPJPE with the det-sign fix: some targets are mirror images, and
    without the fix those would align as reflections."""
    pred, tgt = _pose_pair(2)
    assert _reflected_samples(pred, tgt) > 0
    want = float(jmet.p_mpjpe(jnp.asarray(pred), jnp.asarray(tgt)))
    got = float(tmet.p_mpjpe(torch.from_numpy(pred), torch.from_numpy(tgt)))
    assert abs(got - want) <= METRIC_TOL * abs(want), (got, want)
    # the aligned error of a plain rigid motion of the prediction is ~0
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    moved = (pred @ q.T.astype(np.float32) * 0.7 + 5.0).astype(np.float32)
    assert float(tmet.p_mpjpe(torch.from_numpy(pred), torch.from_numpy(moved))) < 1e-2


@pytest.mark.parametrize("alignment", ["none", "scale", "procrustes"])
def test_pck_and_auc_match_jax(alignment):
    pred, tgt = _pose_pair(4)
    pred, tgt = pred.reshape(-1, J, 3), tgt.reshape(-1, J, 3)
    mask = np.random.default_rng(5).uniform(size=pred.shape[:2]) > 0.2
    for fn in ("keypoint_3d_pck", "keypoint_3d_auc"):
        for m in (None, mask):
            want = getattr(jmet, fn)(jnp.asarray(pred), jnp.asarray(tgt),
                                     None if m is None else jnp.asarray(m), alignment)
            got = getattr(tmet, fn)(torch.from_numpy(pred), torch.from_numpy(tgt),
                                    None if m is None else torch.from_numpy(m), alignment)
            _close(got, want, METRIC_TOL, (fn, alignment))


def test_similarity_transform_matches_jax_with_reflections():
    pred, tgt = _pose_pair(6)
    assert _reflected_samples(pred, tgt) > 0
    want = jmet.compute_similarity_transform(jnp.asarray(pred), jnp.asarray(tgt))
    got = tmet.compute_similarity_transform(torch.from_numpy(pred), torch.from_numpy(tgt))
    _close(got, want, METRIC_TOL)


def test_consistency_metrics_match_jax():
    pred, _ = _pose_pair(7)
    jp, tp = jnp.asarray(pred), torch.from_numpy(pred)
    for mode in ("std", "average", "sum", "min", "max"):
        _close(tmet.segments_time_consistency(tp, T_SKEL, mode),
               jmet.segments_time_consistency(jp, J_SKEL, mode), METRIC_TOL, mode)
        _close(tmet.segments_time_consistency_per_bone(tp, T_SKEL, mode),
               jmet.segments_time_consistency_per_bone(jp, J_SKEL, mode), METRIC_TOL, mode)
    for got, want in zip(tmet.segments_max_stretch_per_bone(tp, T_SKEL),
                         jmet.segments_max_stretch_per_bone(jp, J_SKEL)):
        _close(got, want, METRIC_TOL)
    (got, got_idx), (want, want_idx) = (tmet.segments_max_diff_stretch_per_bone(tp, T_SKEL),
                                        jmet.segments_max_diff_stretch_per_bone(jp, J_SKEL))
    _close(got, want, METRIC_TOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for mode in ("average", "sum"):
        for squared in (True, False):
            _close(tmet.sagittal_symmetry(tp, T_SKEL, mode, squared),
                   jmet.sagittal_symmetry(jp, J_SKEL, mode, squared), METRIC_TOL)
            _close(tmet.sagittal_symmetry_per_bone(tp, T_SKEL, mode, squared),
                   jmet.sagittal_symmetry_per_bone(jp, J_SKEL, mode, squared), METRIC_TOL)
    with pytest.raises(ValueError):
        tmet.sagittal_symmetry(tp, T_SKEL, "max")


@pytest.mark.parametrize("beta", [0.0, 0.1])
def test_scoring_loss_and_hypothesis_concat_match_jax(beta):
    rng = np.random.default_rng(8)
    hyps = rng.normal(size=(2, 3, L, J, 3)).astype(np.float32)
    scores = np.array(jax.nn.softmax(jnp.asarray(rng.normal(size=(2, 3, L, 1))
                                                 .astype(np.float32)), axis=1))
    y = rng.normal(size=(2, L, J, 3)).astype(np.float32)
    want = jmet.wta_with_scoring_loss(jnp.asarray(hyps), jnp.asarray(scores),
                                      jnp.asarray(y), beta)
    got = tmet.wta_with_scoring_loss(torch.from_numpy(hyps), torch.from_numpy(scores),
                                     torch.from_numpy(y), beta)
    for g, w in zip(got if beta else (got,), want if beta else (want,)):
        _close(g, w, METRIC_TOL)
    np.testing.assert_array_equal(
        tm.concat_hyp_and_scores(torch.from_numpy(hyps), torch.from_numpy(scores)).numpy(),
        np.asarray(jm.concat_hyp_and_scores(jnp.asarray(hyps), jnp.asarray(scores))))
    assert tmet.STANDARD_HEVA_WEIGHTS == tuple(jmet.STANDARD_HEVA_WEIGHTS.tolist())


# ---- the eval step -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """The JAX model and its perturbed init, and the port's model with the
    same weights, in fp32, from the small config."""
    extra = [f"model.arch={arch}"]
    j_model, rmcl = j_instantiate(j_load_config("config", OVERRIDES + extra), J_SKEL)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, L, J, 2)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    model, t_rmcl = instantiate_model(load_config("config", OVERRIDES + extra), T_SKEL)
    model.load_state_dict(state_dict_from_jax(params, arch), strict=True)
    assert rmcl == t_rmcl
    return j_model, params, model.eval(), rmcl


def _batch(seed=0, b=3, n_valid=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, J, 2)).astype(np.float32)
    y = (0.1 * rng.normal(size=(b, L, J, 3))).astype(np.float32)
    valid = (np.arange(b) < n_valid).astype(np.float32)
    return x, y, valid


def _step_outputs(arch, tta, x, y, valid):
    j_model, params, model, rmcl = _models(arch)
    cfg = dict(tta=tta, rmcl=rmcl, compute_oracle=rmcl)
    want = j_make_eval_step(j_model.apply, J_SKEL, JEvalConfig(**cfg))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    with torch.inference_mode():
        got = make_eval_step(model, T_SKEL, EvalConfig(**cfg))(
            *(torch.from_numpy(a) for a in (x, y, valid)))
    return got, want


@pytest.mark.parametrize("tta", [True, False])
@pytest.mark.parametrize("arch", ["rmcl_manifold", "mixste"])
def test_eval_step_matches_jax(arch, tta):
    """Every output of the step, with the last row padding (valid = 0)."""
    x, y, valid = _batch()
    got, want = _step_outputs(arch, tta, x, y, valid)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], STEP_TOL, k)
    assert float(got["n_valid"]) == 2.0


def test_eval_step_divides_the_oracle_by_j_once():
    """TTA off: the oracle error sum is the masked sum of per-joint errors
    of the oracle poses over J, once (the reference divides by J twice
    there), and the padded row counts for nothing."""
    model = _models("rmcl_manifold")[2]
    step = make_eval_step(model, T_SKEL, EvalConfig(tta=False))
    x, y, valid = _batch(seed=1)
    with torch.inference_mode():
        got = step(*(torch.from_numpy(a) for a in (x, y, valid)))
        err = np.linalg.norm(got["oracle_preds"].numpy() - y, axis=-1)  # (B, L, J)
        once = float((err * valid[:, None, None]).sum()) / J
        assert abs(float(got["oracle_sum_jointerr"]) - once) <= 1e-5 * once
        assert abs(once / J - once) > 0.5 * once
        y[2] = _batch(seed=2)[1][2]  # change the padded row's target only
        got2 = step(*(torch.from_numpy(a) for a in (x, y, valid)))
    for k in ("sum_jointerr", "oracle_sum_jointerr", "psoracle_sum_jointerr"):
        assert float(got2[k]) == float(got[k]), k


def test_evaluate_matches_jax():
    """``evaluate`` over a loader with a padded last batch: the returned
    predictions (hypotheses with scores), targets and the three MPJPEs."""
    j_model, params, model, _ = _models("rmcl_manifold")
    batches = [_batch(seed=s, b=3, n_valid=3 if s < 2 else 1) for s in range(3)]
    cfg = dict(tta=True, rmcl=True, compute_oracle=True)
    want = j_evaluate(j_model.apply, params, [Batch(*b) for b in batches], J_SKEL,
                      JEvalConfig(**cfg), return_hyps=True)
    got = evaluate(model, [Batch(*b) for b in batches], T_SKEL, EvalConfig(**cfg),
                   return_hyps=True)
    assert model.training is False
    for g_list, w_list in (got[0], want[0]), (got[1], want[1]), (got[5], want[5]):
        assert [a.shape for a in g_list] == [a.shape for a in w_list]
        for g, w in zip(g_list, w_list):
            _close(g, w, STEP_TOL)
    for g, w in zip(got[2:5], want[2:5]):
        assert abs(g - w) <= STEP_TOL * abs(w), (g, w)
    with pytest.raises(ValueError, match="empty loader"):
        evaluate(model, [], T_SKEL, EvalConfig(**cfg))


# ---- bf16 --------------------------------------------------------------------

B16, L16 = 2, 16  # the row counts the fused Pallas MLP takes (test_torch_port_bf16.py)
MANIFOLD16 = dict(num_frame=L16, embed_dim_rot=64, depth_rot=2, num_heads_rot=8,
                  embed_dim_seg=32, depth_seg=1, num_heads_seg=4, n_hyp=3,
                  drop_path_rate=0.0)


def test_bf16_eval_step_matches_jax():
    """rMCL, TTA and the oracle under ``model.dtype=bfloat16``, the JAX
    side on its Pallas kernels (interpret mode), against the bf16 rule
    (module docstring)."""
    outs = {}
    x, y, valid = _batch(seed=3, b=B16, n_valid=1)
    x = np.random.default_rng(3).normal(size=(B16, L16, J, 2)).astype(np.float32)
    y = (0.1 * np.random.default_rng(4).normal(size=(B16, L16, J, 3))).astype(np.float32)
    cfg = dict(tta=True, rmcl=True, compute_oracle=True)
    params = None
    for dtype, jdt, impl in (("float32", jnp.float32, "xla"),
                             ("bfloat16", jnp.bfloat16, "pallas")):
        j_model = jm.RMCLManifoldMixSTE(
            jm.ManifoldConfig(dtype=jdt, attn_impl=impl, mlp_impl=impl, **MANIFOLD16),
            J_SKEL)
        if params is None:
            params = jax.jit(j_model.init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, L16, J, 2)))
            rng = np.random.default_rng(0)
            params = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                params)
        outs[dtype] = j_make_eval_step(j_model.apply, J_SKEL, JEvalConfig(**cfg))(
            params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    model = tm.RMCLManifoldMixSTE(tm.ManifoldConfig(dtype=torch.bfloat16, **MANIFOLD16),
                                  T_SKEL)
    model.load_state_dict(state_dict_from_jax(params, "rmcl_manifold"), strict=True)
    with torch.inference_mode():
        got = make_eval_step(model.eval(), T_SKEL, EvalConfig(**cfg))(
            *(torch.from_numpy(a) for a in (x, y, valid)))
    want, want32 = outs["bfloat16"], outs["float32"]
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        if k in ("scores", "n_valid"):
            _close(got[k], want[k], BF16_TOL, k)
            continue
        scale = max(1.0, float(np.abs(np.asarray(want[k], np.float32)).max()))
        gap = float(np.abs(np.asarray(want[k], np.float32)
                           - np.asarray(want32[k], np.float32)).max()) / scale
        tol = max(BF16_TOL, 2 * gap + GAP_SLACK)
        print(f"bf16 eval step {k}: port vs JAX bf16 {_rel(got[k], want[k]):.4f}, "
              f"JAX bf16 vs fp32 {gap:.4f}, tol {tol:.4f}")
        _close(got[k], want[k], tol, k)


# ---- the test protocol -----------------------------------------------------

@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    """A seeded npz pair for S11 in the H36M layout (two actions, four
    cameras; 40 and 31 frames make 4 and 3 windows a camera)."""
    data_dir = tmp_path_factory.mktemp("h36m_eval")
    rng = np.random.default_rng(0)
    frames = {"Walking": 40, "Eating": 31}
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d={"S11": {
        a: rng.normal(scale=0.3, size=(n, 32, 3)).astype(np.float32)
        for a, n in frames.items()}})
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d={"S11": {
        a: [rng.uniform(0, 1000, size=(n, 17, 2)).astype(np.float32) for _ in range(4)]
        for a, n in frames.items()}})
    return data_dir


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_test_protocol_matches_jax(h36m_dir, tmp_path):
    """``run_test_protocol`` on both sides from one npz pair and one set of
    weights, batch 5 (so the last batch of each action is padded): every
    column of the table, every analytics CSV and array, the CSV headers;
    the port's pickle cache has a name of its own."""
    j_model, params, model, _ = _models("rmcl_manifold")
    over = [f"data.data_dir={h36m_dir}", "train.batch_size_test=5"]
    j_cfg = j_load_config("config", OVERRIDES + over)
    cfg = load_config("config", OVERRIDES + over)
    actions = ["walking", "eating"]
    j_kps, j_ds = j_fetch_and_prepare(j_cfg)
    kps, ds = fetch_and_prepare_data(cfg)
    caches = sorted(p.name for p in h36m_dir.glob("*.pkl"))
    assert caches == ["preproc_data_3d_h36m_17_manipose_tpu.pkl",
                      "preproc_data_3d_h36m_17_manipose_tpu_torch.pkl"]
    want, j_head = j_run_test_protocol(j_model.apply, params, j_cfg, j_ds, j_kps, True,
                                       tmp_path / "jax", actions=actions)
    logger = MetricLogger()
    got, head = run_test_protocol(model, cfg, ds, kps, True, tmp_path / "port",
                                  actions=actions, logger=logger)
    assert head == j_head and got.shape == want.shape
    for c in range(want.shape[1]):
        scale = float(np.abs(want[:, c]).max())
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                   atol=PROTOCOL_TOL * scale, err_msg=head[c + 1])
    assert [r["eval_frames"] for r in logger.history if "eval_frames" in r] == [
        4 * 4 * L, 4 * 3 * L]
    for name in ("protocol_1_err", "seg_symmetry", "seg_consistency", "seg_max_strech",
                 "seg_max_delta_strech", "cw_err", "jw_err"):
        t_head, t_rows = _read_csv(tmp_path / "port" / f"{name}.csv")
        j_head_csv, j_rows = _read_csv(tmp_path / "jax" / f"{name}.csv")
        assert t_head == j_head_csv, name
        assert [r[0] for r in t_rows] == [r[0] for r in j_rows] == actions + ["average"]
        t_vals = np.asarray([r[1:] for r in t_rows], float)
        j_vals = np.asarray([r[1:] for r in j_rows], float)
        scale = np.abs(j_vals).max(axis=0, keepdims=True)
        assert (np.abs(t_vals - j_vals) <= PROTOCOL_TOL * scale).all(), name
    for name in ("all_seg_errs.npy", "all_jw_err_var.npy"):
        g, w = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert np.abs(g - w).max() <= PROTOCOL_TOL * np.abs(w).max(), name
    with open(tmp_path / "port" / "all_pred_hyps.pkl", "rb") as f:
        t_hyps = pickle.load(f)
    with open(tmp_path / "jax" / "all_pred_hyps.pkl", "rb") as f:
        j_hyps = pickle.load(f)
    for (g, _), (w, _) in zip(t_hyps, j_hyps):
        assert g.shape == w.shape and g.shape[-1] == 4
        assert np.abs(g - w).max() <= PROTOCOL_TOL * np.abs(w).max()


def test_eval_only_driver_runs_on_the_cpu(h36m_dir, tmp_path, monkeypatch):
    """``main`` with run.train=false and device=cpu writes the table from
    the seeded init; without ``device`` it asks for the card (and raises
    where there is none); what the driver does not port yet raises."""
    base = OVERRIDES + [f"data.data_dir={h36m_dir}", f"run.output_dir={tmp_path}",
                        "data.actions=walking", "run.train=false"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device 'cuda' requested"):
            main(load_config("config", base))
    base.append("device=cpu")
    assert main(load_config("config", base)) is None
    head, rows = _read_csv(tmp_path / "default" / "protocol_1_err.csv")
    assert head[:2] == ["act", "mpjpe"] and [r[0] for r in rows] == ["walking", "average"]
    assert np.isfinite(np.asarray([r[1:] for r in rows], float)).all()
    for extra in ("run.train=true", "run.viz=true", "parallel.pipe=2",
                  "run.auto_resume=true", "run.checkpoint_params=/nowhere",
                  "run.mlflow_on=true"):
        with pytest.raises(NotImplementedError):
            main(load_config("config", base + [extra]))


def test_csv_logs_are_the_files_pandas_writes(tmp_path):
    """``save_csv_log`` (create, then append) and ``MetricLogger.save_csv``
    (rows with different keys) write what the JAX package's pandas-based
    versions write, byte for byte; ``AverageMeter`` averages as theirs."""
    from manipose_tpu.utils import logging as jlog
    from manipose_tpu_torch.utils import logging as tlog

    table = np.hstack([np.asarray([["walking"], ["average"]]),
                       np.asarray([[1.5, 2.25], [3.0, -0.125]]).astype(str)])
    history = [{"step": 0, "action": "walking", "eval_seconds": 0.5},
               {"step": 1, "mpjpe": 41.25}]
    for side, mod in (("jax", jlog), ("port", tlog)):
        d = tmp_path / side
        d.mkdir()
        mod.save_csv_log(d, ["act", "a", "b"], table, is_create=True, file_name="t")
        mod.save_csv_log(d, ["act", "a", "b"], table[:1], file_name="t")
        mod.save_csv_log(d, ["x", "y"], np.asarray([1, 2]), file_name="v")
        logger = mod.MetricLogger()
        for row in history:
            logger.log({k: v for k, v in row.items() if k != "step"}, step=row["step"])
        logger.save_csv(d)
    for name in ("t.csv", "v.csv", "metrics.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    meters = [jlog.AverageMeter(), tlog.AverageMeter()]
    for m in meters:
        m.update(2.0, n=3)
        m.update(4.0)
    assert meters[0].__dict__ == meters[1].__dict__
