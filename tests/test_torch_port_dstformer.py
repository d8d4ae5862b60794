"""MotionBERT's DSTformer on the port's normal path against the plain
reference ``tests/dstformer_reference.py``, at a tiny size on the CPU:
the forward on (x, y, confidence) and on (x, y) keypoints, the served lift
with flip TTA (``serving.Predictor.predict_video``), the fine-tuning loss's
terms, the first gradient of every leaf and the parameters after three
AdamW steps (``train.step.make_train_step`` with ``model=dstformer
train=motionbert_ft``), the fusion op's plain forward and backward
against autograd, its ``model.fuse`` spans, the published sizes' state
dict, a MotionBERT checkpoint through ``Predictor.from_any``, and the
flagship's optimizer left as it was.

The weights are the reference's seeded draw, whose fusion weights spread
the alphas well away from the published initialisation's 1/2.
Tolerances, each relative to the reference's largest magnitude where not
said otherwise, each with the largest gap read when they were set: the
forward and the lift 1e-5 (fp32 on both sides, the same products summed
in another order through the depths' two streams and their fusions: 6.2e-7);
the loss terms and the steps' losses 1e-5 (a few fp32 reductions); first
gradients 1e-5 a leaf against the largest entry of the leaf (sums over the
batch in another order: 1.2e-6); after three AdamW steps each leaf's
change within 5e-4 of the reference's largest change in the leaf (Adam
divides by the root of the second moment, which magnifies the gradients'
rounding where they are small: 7.9e-5), on the entries whose first
gradient is above rounding level. Under bf16 the forward reads 1.7e-2,
over a thousand times its tolerance
(``test_bf16_misses_the_forward_tolerance``)."""

import numpy as np
import pytest
import torch

import dstformer_reference as ref
from manipose_tpu_torch.config import load_config
from manipose_tpu_torch.drivers.common import instantiate_model
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.models.dstformer import DSTformer, DSTformerConfig
from manipose_tpu_torch.ops import cuda_fusion
from manipose_tpu_torch.serving import Predictor
from manipose_tpu_torch.train import LossConfig, TrainState, make_train_step
from manipose_tpu_torch.train.losses import compute_loss
from manipose_tpu_torch.train.optim import optimizer_from_config
from manipose_tpu_torch.utils import profiling

SKEL = h36m_skeleton_17()
SIZES = dict(ref.PUBLISHED, dim_feat=32, dim_rep=16, depth=2, num_heads=4)
SEQ = 27
OVERRIDES = ["model=dstformer", "train=motionbert_ft", "model.channels=32", "model.nheads=4",
             "model.layers=2", "model.dim_rep=16", f"data.seq_len={SEQ}"]
SEED = 2**31 + 5
LOSS = LossConfig(w_loss=False, vel_loss=20.0, smooth_reg=0.0, rmcl=False, nmpjpe=0.5)
TOL_FORWARD, TOL_LOSS, TOL_GRAD, TOL_CHANGE = 1e-5, 1e-5, 1e-5, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small models on one thread: intra-op threads only contend with the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(extra=()):
    return load_config("config", OVERRIDES + list(extra))


def _model(weights, extra=()):
    model, rmcl = instantiate_model(_cfg(extra), SKEL)
    assert not rmcl
    model.load_state_dict(weights, strict=True)
    return model


def _gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _inputs(seed, chans=2, batch=2):
    gen = torch.Generator().manual_seed(seed)
    x = 0.5 * torch.randn(batch, SEQ, 17, chans, generator=gen)
    y = 0.3 * torch.randn(batch, SEQ, 17, 3, generator=gen)
    return x, y


@pytest.mark.parametrize("chans", [3, 2])
def test_forward_matches_the_reference(chans):
    weights = ref.draw(SIZES, SEED)
    x, _ = _inputs(1, chans)
    if chans == 3:
        x[..., 2] = torch.rand(x.shape[:-1], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = _model(weights).eval()(x)
        want = ref.forward(weights, SIZES, x)
    assert got.shape == want.shape == (2, SEQ, 17, 3)
    assert _gap(got, want) < TOL_FORWARD


def test_drawn_fusions_spread_the_alphas():
    """The reference's draw keeps every depth's alphas well away from 1/2,
    so the softmax and its gradient are exercised."""
    x, _ = _inputs(3)
    for alpha in ref.fusion_weights(ref.draw(SIZES, SEED), SIZES, x):
        a0 = alpha[..., 0]
        assert float((a0 - 0.5).abs().mean()) > 0.1
        assert 0.01 < float(a0.min()) and float(a0.max()) < 0.99


def test_bf16_misses_the_forward_tolerance():
    weights = ref.draw(SIZES, SEED)
    x, _ = _inputs(1)
    with torch.no_grad():
        got = _model(weights, ["model.dtype=bfloat16"]).eval()(x)
        want = ref.forward(weights, SIZES, x)
    assert _gap(got.float(), want) > 100 * TOL_FORWARD


def test_predictor_lifts_with_tta():
    weights = ref.draw(SIZES, SEED)
    video = 0.5 * torch.randn(2 * SEQ + 5, 17, 2, generator=torch.Generator().manual_seed(4))
    pred = Predictor(_cfg(), SKEL, state_dict=weights, batch_size=2, tta=True, device="cpu")
    got = torch.from_numpy(pred.predict_video(video.numpy()))
    idx = torch.clamp(torch.arange(3 * SEQ), max=len(video) - 1)
    with torch.no_grad():
        want = ref.lift(weights, SIZES, video[idx].reshape(3, SEQ, 17, 2), SKEL.joints_left,
                        SKEL.joints_right).reshape(-1, 17, 3)[:len(video)]
    assert _gap(got, want) < TOL_FORWARD


def test_loss_terms_match_the_reference():
    _, y = _inputs(5)
    pred = y + 0.1 * torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
    total, terms = compute_loss(pred, y, LOSS)
    want = ref.loss_terms(pred, y)
    for port, name in (("wloss", "mpjpe"), ("nmpjpe", "n_mpjpe"), ("vloss", "velocity")):
        assert abs(float(terms[port]) - float(want[name])) <= TOL_LOSS * float(want[name])
    assert set(terms) == {"wloss", "nmpjpe", "vloss"}
    assert abs(float(total) - float(sum(want.values()))) <= TOL_LOSS * float(total)


def test_nmpjpe_scale_is_not_detached():
    """The gradient flows through the per-(row, frame) scale: scaling a
    frame's prediction leaves N-MPJPE unchanged, so its gradient is
    orthogonal to the prediction in every frame."""
    _, y = _inputs(7)
    pred = (y + 0.1 * torch.randn(y.shape, generator=torch.Generator().manual_seed(8))
            ).requires_grad_(True)
    _, terms = compute_loss(pred, y, LossConfig(w_loss=False, vel_loss=0.0, smooth_reg=0.0,
                                                rmcl=False, nmpjpe=1.0))
    (grad,) = torch.autograd.grad(terms["nmpjpe"], pred)
    radial = (grad * pred.detach()).sum(dim=(-1, -2)).abs()
    assert float(radial.max()) < 1e-5 * float(grad.abs().max())


def _reference_steps(weights, batches, lr, wd):
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    opt = ref.AdamW(params, lr, wd)
    losses, first = [], None
    for x, y in batches:
        loss = sum(ref.loss_terms(ref.forward(params, SIZES, x), y).values())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        first = grads if first is None else first
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}


def test_train_steps_match_the_reference():
    """Three AdamW steps of the port's train step (``model=dstformer
    train=motionbert_ft``, with the loss ``train.loop`` builds): the loss of
    each, the first gradient of every leaf (Adam's first moment after one
    step), and every leaf's change."""
    weights = ref.draw(SIZES, SEED)
    cfg = _cfg()
    model = _model(weights)
    opt = optimizer_from_config(model, cfg)
    assert isinstance(opt.adam, torch.optim.AdamW)
    assert opt.adam.defaults["weight_decay"] == 0.01
    state = TrainState.create(model, opt, device="cpu")
    step = make_train_step(model, LossConfig(
        w_loss=cfg.train.w_loss, vel_loss=cfg.train.vel_loss, smooth_reg=cfg.train.smooth_reg,
        rmcl=False, nmpjpe=cfg.train.nmpjpe), SKEL, opt)
    batches = [_inputs(10 + i) for i in range(3)]
    names = {id(p): n for n, p in model.named_parameters()}
    losses, first = [], None
    for x, y in batches:
        losses.append(float(step(state, x, y, cfg.train.lr)["loss"]))
        if first is None:
            first = {names[id(p)]: opt.adam.state[p]["exp_avg"] / 0.1 for p in opt.params}
    want_losses, want_first, want_after = _reference_steps(weights, batches, cfg.train.lr,
                                                           cfg.train.weight_decay)
    np.testing.assert_allclose(losses, want_losses, rtol=TOL_LOSS)
    assert set(first) == set(want_first)
    for name, g in want_first.items():
        assert _gap(first[name], g) < TOL_GRAD, name
    # entries whose first gradient is at rounding level (a key's bias under
    # the softmax) take Adam's normalised step in either direction: left out
    rms = [float(g.norm()) / g.numel() ** 0.5 for g in want_first.values()]
    floor = 1e-3 * float(np.median(rms))
    after = dict(model.named_parameters())
    for name, w in want_after.items():
        keep = want_first[name].abs() >= floor
        change = (w - weights[name])[keep]
        assert _gap((after[name].detach() - weights[name])[keep], change) < TOL_CHANGE, name


def test_fusion_plain_matches_autograd():
    """``fusion_plain`` and ``fusion_plain_bwd`` (the kernels' arithmetic)
    against autograd through the reference's concatenation, Linear and
    softmax."""
    gen = torch.Generator().manual_seed(9)
    r, c = 40, 24
    xs, xt = torch.randn(r, c, generator=gen), torch.randn(r, c, generator=gen)
    w, b = 0.3 * torch.randn(2, 2 * c, generator=gen), torch.randn(2, generator=gen)
    g = torch.randn(r, c, generator=gen)
    leaves = [t.clone().requires_grad_(True) for t in (xs, xt, w, b)]
    alpha = torch.softmax(torch.nn.functional.linear(torch.cat(leaves[:2], -1), leaves[2],
                                                     leaves[3]), -1)
    want = alpha[:, :1] * leaves[0] + alpha[:, 1:] * leaves[1]
    want_grads = torch.autograd.grad(want, leaves, g)
    out, a = cuda_fusion.fusion_plain(xs, xt, w, b)
    assert torch.allclose(out, want, rtol=1e-6, atol=1e-6)
    assert torch.allclose(a, alpha, rtol=1e-6, atol=1e-7)
    for got, wanted in zip(cuda_fusion.fusion_plain_bwd(g, xs, xt, a, w), want_grads):
        assert got.shape == wanted.shape
        assert _gap(got, wanted) < 1e-6
    leaves = [t.clone().requires_grad_(True) for t in (xs, xt, w, b)]
    got_grads = torch.autograd.grad(cuda_fusion.stream_fusion(*leaves), leaves, g)
    for got, wanted in zip(got_grads, want_grads):
        assert _gap(got, wanted) < 1e-6


def test_fusion_spans_count_the_rows():
    """Five ``model.fuse`` spans a forward at the published depth, each
    with rows B*F*J."""
    cfg = DSTformerConfig(embed_dim=16, dim_rep=8, num_heads=2, maxlen=SEQ)
    model = DSTformer(cfg).init_weights(0).eval()
    profiling.reset()
    with torch.no_grad():
        model(torch.zeros(3, SEQ, 17, 2))
    spans = [s for s in profiling.spans() if s.name == "model.fuse"]
    assert len(spans) == cfg.depth == 5
    assert all(s.counts == {"rows": 3 * SEQ * 17} for s in spans)
    assert profiling.totals()["model.fuse"] == {"rows": 5 * 3 * SEQ * 17}


@pytest.mark.parametrize("variant", ["model.drop_path_rate=0.1", "model.remat=true",
                                     "model.layout=joint_major", "quant"])
def test_variants_it_is_not_built_with_are_refused(variant):
    """No drop-path (as published), int8, remat or joint-major layout."""
    extra = [] if variant == "quant" else [variant]
    with pytest.raises(ValueError):
        instantiate_model(_cfg(extra), SKEL, quant=variant == "quant")


def test_published_sizes_and_init():
    """At MotionBERT's published sizes the port's state dict has the
    reference's names and shapes, about 42.5M parameters; its init starts
    every fusion at 1/2."""
    with torch.device("meta"):
        model = DSTformer(DSTformerConfig())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == dict(ref.shapes(ref.PUBLISHED))
    assert 42.0e6 < sum(int(np.prod(s)) for s in got.values()) < 43.0e6
    small = DSTformer(DSTformerConfig(embed_dim=16, dim_rep=8, num_heads=2, depth=1,
                                      maxlen=SEQ)).init_weights(3).requires_grad_(False)
    assert float(small.ts_attn[0].weight.abs().max()) == 0.0
    assert small.ts_attn[0].bias.tolist() == [0.5, 0.5]
    assert 0.015 < float(small.temp_embed.std()) < 0.025


def test_motionbert_checkpoint_loads(tmp_path):
    """A MotionBERT fine-tuning checkpoint: ``model_pos`` under
    ``DataParallel``'s ``module.`` prefix, beside the epoch, the rates and
    the optimizer's state, through ``Predictor.from_any``."""
    weights = ref.draw(SIZES, SEED)
    path = tmp_path / "motionbert_h36m.pth"
    torch.save({"epoch": 60, "lr": [4.9e-4], "min_loss": 35.2,
                "optimizer": {"state": {}, "param_groups": [{"lr": 4.9e-4, "params": [0]}]},
                "model_pos": {"module." + k: v for k, v in weights.items()}}, path)
    pred = Predictor.from_any(str(path), cfg=_cfg(), batch_size=2, tta=False, device="cpu")
    x, _ = _inputs(11)
    with torch.no_grad():
        got = pred.model(x)
        want = ref.forward(weights, SIZES, x)
    assert _gap(got, want) < TOL_FORWARD


def test_flagship_optimizer_is_unchanged():
    """Without ``train.optimizer`` and ``train.weight_decay`` the optimizer
    is torch's Adam with coupled decay 1e-6, as before AdamW was added, and
    its step is torch Adam's bit for bit."""
    model = torch.nn.Linear(4, 3)
    opt = optimizer_from_config(model, load_config("config"))
    assert type(opt.adam) is torch.optim.Adam
    assert opt.adam.defaults["weight_decay"] == 1e-6
    twin = torch.nn.Linear(4, 3)
    twin.load_state_dict(model.state_dict())
    plain = torch.optim.Adam(twin.parameters(), lr=1e-3, weight_decay=1e-6)
    for i in range(3):
        x = torch.randn(5, 4, generator=torch.Generator().manual_seed(i))
        for m in (model, twin):
            m.zero_grad()
            m(x).square().sum().backward()
        opt.step(1e-3)
        plain.step()
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        optimizer_from_config(model, load_config("config", ["train.optimizer=sgd"]))


def test_mup_with_adamw_is_refused():
    """muP's optimizer is MuAdam, with coupled decay: ``model.mup=true``
    with ``train.optimizer=adamw`` is refused, not run half-tested."""
    model = torch.nn.Linear(4, 3)
    with pytest.raises(ValueError, match="mup"):
        optimizer_from_config(model, load_config(
            "config", ["model.mup=true", "train.optimizer=adamw"]))
