"""Training: the per-batch path of ``train.loop.train`` on one card.
``SequenceLoader`` (random starts, flips, shuffling) over a seeded
synthetic archive, ``prefetch`` pinning batches on its thread,
``Batch.to_device``, then the step of ``train.step.make_train_step``
(the configuration's losses, Adam, the drop-path generator of the train
state). The archive holds more windows than a run steps through, so no
epoch ends in it, as none does in a real epoch's first hours.

Set-up builds the one train state and drives its first steps through the
window's own call and feed; the reference follows the first of them.

``train_seq_per_s``: the sequences of every step begun in the window over
the time from its start to the end of the last of them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import checks, common, core, reference, tracing

# the mix's sizes and the window's length in the benchmark's tiny runs
TINY = dict(batch_size=4, lengths={"min": 60, "max": 120, "count": 4}, frames=30000,
            warm_steps=1)
TINY_SEQ_LEN = 27


def build(ctx, batch_size: int, seed: int, mesh=None):
    """(state, step, batch iterator, learning rate) for this cell."""
    from manipose_tpu_torch.data import PoseSequenceDataset, SequenceLoader, prefetch
    from manipose_tpu_torch.drivers.common import instantiate_model
    from manipose_tpu_torch.train.optim import optimizer_from_config
    from manipose_tpu_torch.train.step import TrainState, make_train_step

    mix = ctx.mix
    cfg = ctx.port_config([f"train.batch_size={batch_size}"])
    common.check_port_config(ctx, cfg)
    skeleton = ctx.port_skeleton()
    model, rmcl = instantiate_model(cfg, skeleton)
    model.load_state_dict(common.draw_weights(ctx), strict=True)
    if mesh is not None:
        from manipose_tpu_torch.parallel.mesh import GradSync, shard_params

        model = shard_params(model.to(ctx.device), mesh, mode=cfg.parallel.mode)
    optimizer = optimizer_from_config(model, cfg)
    if mesh is not None:
        optimizer.sharding = GradSync(model, optimizer.params)
    state = TrainState.create(model, optimizer, seed=seed, device=ctx.device)
    loss_cfg = getattr(ctx.arch, "port_loss_config", port_loss_config)(cfg, rmcl)
    step = make_train_step(model, loss_cfg, skeleton, optimizer)
    archive = archive_videos(ctx)
    dataset = PoseSequenceDataset(
        [p for _, p in archive], [k for k, _ in archive], seq_len=ctx.config["data"]["seq_len"],
        random_start=True, miss_type=cfg.data.miss_type, miss_rate=cfg.data.miss_rate,
        noise_sigma=cfg.data.noise_sigma, skeleton=skeleton,
        flip_probability=mix["flip_probability"])
    loader = SequenceLoader(dataset, batch_size=batch_size, shuffle=True, seed=ctx.seed)
    on_card = ctx.device == "cuda"
    batches = prefetch((b.pin_memory() for b in loader) if on_card else loader)
    return state, step, batches, float(cfg.train.lr), len(loader)


def port_loss_config(port_cfg, rmcl: bool):
    """The program's loss settings, as ``train.loop.train`` builds them for
    every model; an architecture module whose differ gives its own."""
    from manipose_tpu_torch.train.losses import LossConfig

    t = port_cfg.train
    return LossConfig(sq_loss=t.sq_loss, w_loss=t.w_loss, vel_loss=t.vel_loss,
                      smooth_reg=t.smooth_reg, rmcl_score_reg=t.rmcl_score_reg,
                      rigid_seg_reg=t.rigid_seg_reg, rmcl=rmcl)


def archive_videos(ctx):
    """The synthetic archive: videos of the mix's lengths until it holds
    ``frames`` frames."""
    spec = ctx.mix["lengths"]
    n = int(np.ceil(ctx.mix["frames"] / ((spec["min"] + spec["max"]) / 2)))
    return common.make_videos(ctx, common.lengths_plan(spec, n, ctx.seed), stream=1)


def run(ctx) -> core.Outcome:
    mix = ctx.mix
    batch_size = mix["batch_size"]  # the global batch: each rank steps its share
    spans = tracing.Spans(annotate=ctx.trace)
    mesh, drop_seed, control = None, ctx.seed, None
    if ctx.world > 1:
        import torch.distributed as dist
        from manipose_tpu_torch.parallel.mesh import mesh_from_config, rank_seed, shard_batch

        mesh = mesh_from_config(ctx.port_config([f"train.batch_size={batch_size}"]), ctx.device)
        drop_seed = rank_seed(ctx.seed, mesh)
        # rank 0's clock decides for every rank when the window closes
        control = dist.new_group(backend="gloo")
    state, step, batches, lr, epoch_steps = build(ctx, batch_size, drop_seed, mesh)
    common.log(ctx, "train state, archive and loader built")
    common.inputs_made(ctx)
    base = getattr(state.model, "module", state.model)
    names = {id(p): n for n, p in base.named_parameters()}
    metrics = []
    fed = []  # (pose_2d, pose_3d) of the checked steps, as the feed gave them
    device = torch.device(ctx.device)

    def one_step():
        with spans.span("loader_wait"):
            batch = next(batches, None)
        if batch is None:
            raise RuntimeError(f"the archive's epoch of {epoch_steps} steps ended in the run")
        with spans.span("step"):
            x2d, x3d, _ = batch.to_device(device)
            if mesh is not None:
                x2d, x3d = shard_batch((x2d, x3d), mesh)
            metrics.append(step(state, x2d, x3d, lr))
        return batch

    def running(clock) -> bool:
        go = clock.running()
        if control is None:
            return go
        flag = torch.tensor([int(go)])
        torch.distributed.broadcast(flag, src=0, group=control)
        return bool(flag.item())

    snapshots = {}
    for i in range(mix["checked_steps"]):
        batch = one_step()
        fed.append((batch.pose_2d.copy(), batch.pose_3d.copy()))
        if i == 0:  # the first gradient, from Adam's first moment after one step
            snapshots["first_grads"] = checks.first_gradients(state.optimizer, names)
    snapshots["after"] = {names[id(p)]: p.detach().to("cpu", copy=True)
                          for p in state.optimizer.params}
    for _ in range(mix["warm_steps"]):
        one_step()
    common.sync(ctx.device)
    common.log(ctx, "first steps taken")

    clock = common.Clock(ctx.seconds)
    setup_s = clock.t0 - ctx.t_start
    before = len(metrics)
    while running(clock):
        one_step()
    common.sync(ctx.device)
    elapsed = time.perf_counter() - clock.t0
    steps = len(metrics) - before
    waits = list(spans.by_name["loader_wait"][-steps:]) if steps else []
    result = {}
    if ctx.trace:
        with tracing.traced(ctx.rank == 0, result):
            for _ in range(mix["trace_steps"]):
                one_step()
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu().numpy()
    peak = core.memory_peak_bytes(ctx.device)
    program_losses = [float(v) for v in losses[:mix["checked_steps"]]]
    failed = int(np.sum(~np.isfinite(losses)))
    batches.close()
    del state, step, batches, metrics
    if control is not None:  # every rank's losses and peak to rank 0
        import torch.distributed as dist

        gathered = [None] * ctx.world
        dist.all_gather_object(gathered, (program_losses, peak, failed), group=control)
        dist.destroy_process_group()
        if ctx.rank != 0:
            return None
        program_losses = list(np.mean([g[0] for g in gathered], axis=0))
        peak = max(g[1] for g in gathered)
        failed = sum(g[2] for g in gathered)
    common.log(ctx, f"window: {steps} steps in {elapsed:.3f} s")
    work = {"steps": steps, "window_s": elapsed, "forward_windows": steps * batch_size,
            "backward": True, "chips": ctx.world,
            "loader_wait_s": sum(b - a for a, b in waits),
            "traced_calls": [(batch_size // ctx.world, mix["trace_steps"] if ctx.trace else 0,
                              True)]}
    seeds = drop_seeds(ctx)

    def check():
        return checks.train_checks(ctx, fed, program_losses, snapshots, archive_videos(ctx),
                                   drop_seeds=seeds)

    return core.Outcome(setup_s, {"train_seq_per_s": steps * batch_size / elapsed},
                        len(losses), failed, work, spans, check, result.get("trace"), peak)


def drop_seeds(ctx):
    """Each data-parallel rank's drop-path seed, as the program seeds it
    (``parallel.mesh.rank_seed``: the run's seed plus 1000003 a rank)."""
    return [ctx.seed + 1_000_003 * r for r in range(int(ctx.mix.get("ranks", 1)))]


def control(ctx, kind):
    """The reference in TF32 (``tf32``), or on half of each batch
    (``half_batch``), or on rank 0's rows alone (``no_exchange``), standing
    in for the program (``controls.py``). Batches drawn as the loader draws
    them (random windows of the archive, half of them flipped), then the
    stand-in's steps against the reference's."""
    mix = ctx.mix
    seq_len, b = ctx.config["data"]["seq_len"], mix["batch_size"]
    archive = archive_videos(ctx)
    rng = np.random.default_rng([ctx.seed, 4])
    fed = []
    for _ in range(mix["checked_steps"]):
        xs, ys = [], []
        for _ in range(b):
            kp, pose = archive[rng.integers(len(archive))]
            s = rng.integers(len(kp) - seq_len)
            x, y = torch.from_numpy(kp[s:s + seq_len]), torch.from_numpy(pose[s:s + seq_len])
            if rng.uniform() < mix["flip_probability"]:
                x, y = reference.flip(x, ctx.config["skeleton"]), reference.flip(y, ctx.config["skeleton"])
            xs.append(x.numpy())
            ys.append(y.numpy())
        fed.append((np.stack(xs), np.stack(ys)))
    seeds = drop_seeds(ctx)
    stand_in = checks.follow(ctx, fed, seeds, tf32=kind == "tf32",
                             fault="" if kind == "tf32" else kind)
    start = {k: v.cpu() for k, v in common.draw_weights(ctx).items()}
    snapshots = {"first_grads": {k: v.cpu() for k, v in stand_in["first_grads"].items()},
                 "after": {k: start[k] + v.cpu() for k, v in stand_in["change"].items()}}
    losses = stand_in["losses"]
    del stand_in
    torch.cuda.empty_cache()
    return checks.train_numbers(ctx, fed, losses, snapshots, seeds)
