"""MotionBERT's DSTformer in the benchmark (``archs/dstformer.py``, the
cell mb-h36m-train-b32): the architecture's reference against the port at
its ``TINY`` size on the CPU (the forward on two and three channels, the
served lift with TTA, AdamW steps), the blocked reference step against the
unblocked one, the yardstick's counts at the published sizes, and the
fusion's two readers on a tiny run's work with a trace laid over it."""

import types

import pytest
import torch

import tiny
from archs import dstformer
from harness import core, synth, tracing

CELL = "mb-h36m-train-b32"
MS = 1_000_000  # ns


@pytest.fixture(scope="module")
def mb():
    torch.set_num_threads(2)
    cell = tiny.tiny(core.Cell.find(CELL))
    ctx = core.Context(cell, 2**31 + 9, 1.0, False, "cpu", 0.0)
    return ctx, dstformer.draw(cell.config, ctx.seed, "cpu")


def _model(ctx, sd):
    from manipose_tpu_torch.drivers.common import instantiate_model

    model, rmcl = instantiate_model(ctx.port_config(), ctx.port_skeleton())
    assert not rmcl
    model.load_state_dict(sd, strict=True)
    return model


def _windows(ctx, n, seed=1):
    seq = ctx.config["data"]["seq_len"]
    kp = synth.host(synth.videos([seq * n], ctx.config["camera"], ctx.config["skeleton"],
                                 torch.Generator().manual_seed(seed), "cpu"))[0]
    return torch.from_numpy(kp[0].reshape(n, seq, 17, 2)), torch.from_numpy(
        kp[1].reshape(n, seq, 17, 3))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("chans", [2, 3])
def test_forward_matches_the_port(mb, chans):
    ctx, sd = mb
    x, _ = _windows(ctx, 2)
    if chans == 3:
        x = torch.cat([x, torch.rand(x.shape[:-1] + (1,), generator=torch.Generator()
                                     .manual_seed(2))], dim=-1)
    with torch.no_grad():
        got = _model(ctx, sd).eval()(x)
        want = dstformer.forward(sd, ctx.config, x)
    assert _gap(got, want) <= 1e-5


def test_lift_matches_the_port(mb):
    from manipose_tpu_torch.serving import Predictor

    ctx, sd = mb
    pred = Predictor(ctx.port_config(), ctx.port_skeleton(), state_dict=sd, batch_size=2,
                     device="cpu")
    x, _ = _windows(ctx, 2, seed=3)
    with torch.no_grad():
        want = dstformer.lift_windows(sd, ctx.config, x, tta=True)
    assert _gap(torch.from_numpy(pred.forward_windows(x.numpy())), want) <= 1e-5


def test_adamw_steps_match_the_port(mb):
    """Three steps of the port's step with the optimizer and loss the
    driver builds (``train=motionbert_ft``: AdamW, N-MPJPE) against the
    reference's."""
    from manipose_tpu_torch.train import TrainState, make_train_step
    from manipose_tpu_torch.train.optim import optimizer_from_config

    ctx, sd = mb
    cfg = ctx.port_config()
    model = _model(ctx, sd)
    opt = optimizer_from_config(model, cfg)
    state = TrainState.create(model, opt, device="cpu")
    step = make_train_step(model, dstformer.port_loss_config(cfg, False), None, opt)
    batches = [_windows(ctx, 4, seed=10 + i) for i in range(3)]
    losses = [float(step(state, x, y, float(cfg.train.lr))["loss"]) for x, y in batches]
    ref = dstformer.train_steps(sd, ctx.config, batches, [torch.Generator()])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    after = dict(model.named_parameters())
    change = {k: (after[k].detach() - sd[k]).norm() for k in sd}
    want = {k: v.norm() for k, v in ref["change"].items()}
    gaps = sorted(float(abs(change[k] - want[k]) / want[k]) for k in sd if want[k] > 0)
    assert gaps[len(gaps) // 2] <= 1e-4


def test_the_blocked_step_is_the_whole_batchs(mb):
    ctx, sd = mb
    batches = [_windows(ctx, 4, seed=20 + i) for i in range(2)]
    gens = [torch.Generator()]
    whole = dstformer.train_steps(sd, ctx.config, batches, gens, block=4)
    blocked = dstformer.train_steps(sd, ctx.config, batches, gens, block=1)
    assert blocked["losses"] == pytest.approx(whole["losses"], rel=1e-6)
    for k, g in whole["first_grads"].items():
        assert _gap(blocked["first_grads"][k], g) <= 1e-5, k


def test_yardstick_at_the_published_sizes():
    """3.7e11 matrix FLOPs a 243-frame window; K1-K6 launches of two
    streams of depth 5; the fusion's bytes a depth at B = 32: 0.81 GB
    forward, 1.35 GB backward."""
    cfg = core.Cell.find(CELL).config
    assert dstformer.model_flops(cfg, 1) == pytest.approx(3.7e11, rel=0.01)
    counts = {}
    for (op, _), n in dstformer.kernel_ops(cfg, 32, True).items():
        counts[op] = counts.get(op, 0) + n
    assert counts == {"attention_packed": 10, "attention_dense": 10, "fused_mlp": 20,
                      "attention_packed_bwd": 10, "attention_dense_bwd": 10,
                      "fused_mlp_bwd": 20}
    assert ("fused_mlp", (132192, 512, 1024)) in dstformer.kernel_ops(cfg, 32, False)
    _, fwd = dstformer.fusion_work(cfg, 32, False)
    _, both = dstformer.fusion_work(cfg, 32, True)
    assert fwd / 5 == pytest.approx(0.81e9, rel=0.01)
    assert (both - fwd) / 5 == pytest.approx(1.35e9, rel=0.01)


def test_fusion_readers_on_a_tiny_run():
    """A tiny sound run's work, with a trace laid over it: 2 ms of fusion
    kernels among 10 ms busy in a 20 ms window."""
    cell = tiny.tiny(core.Cell.find(CELL))
    cell.per_layer = [m for m in core.Cell.find(CELL).per_layer]
    ctx = core.Context(cell, 2**31 + 13, 0.5, False, "cpu", 0.0)
    outcome = cell.driver().run(ctx)
    trace = tracing.Trace([("void stream_fusion_kernel(...)", 0, MS),
                           ("void stream_fusion_bwd_rows_kernel(...)", 2 * MS, 3 * MS),
                           ("void fused_mlp_kernel<float>(P)", 4 * MS, 12 * MS)],
                          [], 0, (0, 20 * MS))
    outcome.trace = trace
    outcome.work["traced_calls"] = [(4, 2, True)]
    run = core.Run(cell, outcome)
    share = cell.reader("fusion_share.train")(run)
    assert share == pytest.approx(20.0)
    flops, n_bytes = dstformer.fusion_work(cell.config, 4, True)
    bound = 2 * max(flops / 165e12, n_bytes / 3.35e12)
    assert cell.reader("fusion_roofline.train")(run) == pytest.approx(100 * bound / 2e-3)
    # no fusion kernel in the trace, or no trace: nothing to read
    outcome.trace = tracing.Trace([("void fused_mlp_kernel<float>(P)", 0, MS)], [], 0, (0, MS))
    assert cell.reader("fusion_share.train")(run) is None
    assert cell.reader("fusion_roofline.train")(run) is None
    outcome.trace = None
    assert cell.reader("fusion_roofline.train")(run) is None


def test_fusion_roofline_is_none_for_an_architecture_without_a_fusion():
    run = types.SimpleNamespace(
        cell=types.SimpleNamespace(arch=lambda: types.SimpleNamespace(),
                                   bench_dir=core.BENCH_DIR),
        trace=tracing.Trace([("void stream_fusion_kernel(...)", 0, MS)], [], 0, (0, MS)),
        work={"traced_calls": [(4, 2, True)]}, config={})
    assert core.Cell.find(CELL).reader("fusion_roofline.train")(run) is None
