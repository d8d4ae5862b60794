"""One gloo CPU rank of the port's multi-rank tests (``tests/torch_ranks.py``).

``python tests/torch_rank_worker.py <task> <dir>``, with the launcher's
environment. It imports torch and the port, never JAX: it reads
``<dir>/inputs.pt`` (weights and data the test made from a seed), runs the
task's checks on its rank, and rank 0 writes ``<dir>/results.pt`` (and
``ok``) for the test to hold against the JAX package.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from manipose_tpu_torch import models as tm
from manipose_tpu_torch import train as tt
from manipose_tpu_torch.geometry import h36m_skeleton_17
from manipose_tpu_torch.parallel import (
    RingSpec,
    barrier,
    global_batch,
    initialize_multihost,
    is_primary,
    make_hybrid_mesh,
    make_mesh,
    pipeline_apply,
    ring_attention,
    shard_batch,
    shard_params,
)
from manipose_tpu_torch.parallel.flagship import make_pipelined_apply
from manipose_tpu_torch.parallel.mesh import (
    GradSync,
    axis_index,
    full_grads,
    full_state_dict,
    local_part,
    mesh_from_config,
    mesh_shape,
    rank_seed,
    unwrap,
)

SKEL = h36m_skeleton_17()
MODES = ("tp", "dp", "fsdp_dp", "fsdp")


def _gather_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """The data shards of ``t`` concatenated in data order."""
    group = mesh.get_group("data")
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _data_mean(t: torch.Tensor, mesh) -> float:
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.get_group("data"))
    return float(t) / mesh.size(0)


def _model(cfg: dict, weights: dict, **kw) -> torch.nn.Module:
    model = tm.RMCLManifoldMixSTE(tm.ManifoldConfig(**cfg, **kw), SKEL)
    model.load_state_dict(weights, strict=True)
    return model


def _sharded_steps(inp, mesh, mode, grad_clip=0.0):
    """The rMCL model under ``mode``: the eval forward, then two train steps
    (the data-mean loss of each, the first step's gradients and the final
    weights, whole)."""
    net = shard_params(_model(inp["cfg"], inp["weights"]), mesh, mode)
    x, y = shard_batch((inp["x"], inp["y"]), mesh)
    with torch.no_grad():
        poses, scores = net.eval()(x)
    net.train()
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6, grad_clip=grad_clip)
    opt.sharding = GradSync(net, opt.params)
    state = tt.TrainState.create(net, opt, seed=rank_seed(0, mesh), device="cpu")
    step = tt.make_train_step(net, tt.LossConfig(), SKEL, opt)
    losses = [_data_mean(step(state, x, y, 1e-3)["loss"], mesh)]
    grads = full_grads(net)
    losses.append(_data_mean(step(state, x, y, 1e-3)["loss"], mesh))
    return {"losses": losses, "grads": grads, "poses": _gather_data(poses, mesh),
            "scores": _gather_data(scores, mesh), "params": full_state_dict(net),
            "resume": _resume(inp, mesh, mode, state, step, x, y)}


def _resume(inp, mesh, mode, state, step, x, y):
    """Save the train state (every rank gathers, rank 0 writes), restore it
    into a fresh sharded model and optimizer, and take one more step on
    both: the same weights, Adam moments and loss."""
    from manipose_tpu_torch.parallel.mesh import full_optimizer_state
    from manipose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    directory = inp["out"] / f"resume_{mode}"
    save_checkpoint(directory, "train_state_000002", state, block=True)
    dist.barrier()
    net = shard_params(_model(inp["cfg"], inp["weights"]), mesh, mode)
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6)
    opt.sharding = GradSync(net, opt.params)
    fresh = tt.TrainState.create(net, opt, seed=123, device="cpu")
    restore_checkpoint(directory, "train_state_000002", fresh)
    want_sd, got_sd = full_state_dict(state.model), full_state_dict(net)
    want_opt = full_optimizer_state(state.model, state.optimizer)["state"]
    got_opt = full_optimizer_state(net, opt)["state"]
    same = (all(torch.equal(want_sd[k], got_sd[k]) for k in want_sd)
            and all(torch.equal(want_opt[i][k], got_opt[i][k])
                    for i in want_opt for k in ("exp_avg", "exp_avg_sq"))
            and torch.equal(state.generator.get_state(), fresh.generator.get_state())
            and fresh.step == state.step)
    step2 = tt.make_train_step(net, tt.LossConfig(), SKEL, opt)
    losses = [_data_mean(s(st, x, y, 1e-3)["loss"], mesh)
              for s, st in ((step, state), (step2, fresh))]
    return {"same_state": same, "losses": losses}


def task_parallel(out: Path) -> dict:
    inp = torch.load(out / "inputs.pt", weights_only=False)
    inp["out"] = out
    results = {}
    # ring attention on rings of 2 (a 2 x 2 mesh) and 4 (1 x 4)
    for data, ring in ((2, 2), (1, 4)):
        mesh = make_mesh(data, ring)
        for n, (q, k, v) in inp["ring"].items():
            q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
            o = ring_attention(q, k, v, q.shape[-1] ** -0.5, mesh, "model", "data")
            (o ** 2).sum().backward()
            results[f"ring{ring}_{n}"] = [o.detach(), q.grad, k.grad, v.grad]
    # the rMCL train step and eval forward under each mode on data 2 x model 2
    mesh = make_mesh(2, 2)
    for mode in MODES:
        results[mode] = _sharded_steps(inp, mesh, mode)
    # global-norm clipping over the shards: the clipped gradients of one
    # step against those of one process
    plain = _model(inp["cfg"], inp["weights"])
    opt = tt.make_optimizer(plain.parameters(), weight_decay=1e-6, grad_clip=0.05)
    state = tt.TrainState.create(plain, opt, seed=0, device="cpu")
    tt.make_train_step(plain, tt.LossConfig(), SKEL, opt)(state, inp["x"], inp["y"], 1e-3)
    results["clip_plain"] = {n: p.grad for n, p in plain.named_parameters()}
    for mode in MODES:
        net = shard_params(_model(inp["cfg"], inp["weights"]), mesh, mode)
        opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6, grad_clip=0.05)
        opt.sharding = GradSync(net, opt.params)
        state = tt.TrainState.create(net, opt, seed=0, device="cpu")
        x, y = shard_batch((inp["x"], inp["y"]), mesh)
        tt.make_train_step(net, tt.LossConfig(), SKEL, opt)(state, x, y, 1e-3)
        results[f"clip_{mode}"] = full_grads(net)
    # the ring trunk (attn_impl=ring) of the whole model
    ring_model = _model(inp["cfg"], inp["weights"], attn_impl="ring",
                        ring=RingSpec(mesh, "model", "data"))
    (x,) = shard_batch((inp["x"],), mesh)
    with torch.no_grad():
        poses, scores = ring_model.eval()(x)
    results["ring_model"] = [_gather_data(poses, mesh), _gather_data(scores, mesh)]
    # the launch helpers in a real world
    hybrid = make_hybrid_mesh(2, 2)
    barrier("parallel-checks")
    (shard,) = global_batch([torch.full((2,), float(dist.get_rank()))], hybrid)
    rows = _gather_data(shard, hybrid)
    results["multihost"] = {"shape": mesh_shape(hybrid), "primary": is_primary(),
                            "rows": rows, "data_index": axis_index(hybrid, "data")}
    return results


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _stage_holdings(net, mesh) -> list:
    """Every rank's (pipe stage, the trunk blocks whose parameters it holds,
    the elements of its parameters)."""
    trunk = unwrap(net).rotations_module

    def held(blocks):
        return [i for i, b in enumerate(blocks) if all(p.numel() for p in b.parameters())]

    mine = (axis_index(mesh, "pipe"), held(trunk.STEblocks), held(trunk.TTEblocks),
            sum(local_part(p).numel() for p in net.parameters()))
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    return parts


def _pipe_resume(inp, mesh, state, step, x, y, pstate):
    """The pipelined fsdp_dp train state saved (each stage's blocks gathered,
    rank 0 writes) and restored into a fresh pipelined model: the same
    weights and moments, the optimizer state in the single-device layout
    (the one-process optimizer's indices and shapes), and one more step on
    both gives the same loss."""
    from manipose_tpu_torch.parallel.mesh import full_optimizer_state
    from manipose_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    directory = inp["out"] / "resume_pipe"
    save_checkpoint(directory, "train_state_000002", state, block=True)
    dist.barrier()
    net = shard_params(make_pipelined_apply(_model(inp["cfg"], inp["weights"]), mesh,
                                            data_axis="data", microbatches=2),
                       mesh, "fsdp_dp")
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6)
    opt.sharding = GradSync(net, opt.params)
    fresh = tt.TrainState.create(net, opt, seed=123, device="cpu")
    restore_checkpoint(directory, "train_state_000002", fresh)
    want_sd, got_sd = full_state_dict(state.model), full_state_dict(net)
    want_opt = full_optimizer_state(state.model, state.optimizer)["state"]
    got_opt = full_optimizer_state(net, opt)["state"]
    plain_opt = pstate.optimizer.adam.state_dict()["state"]
    same = (list(want_sd) == list(got_sd)
            and all(torch.equal(want_sd[k], got_sd[k]) for k in want_sd)
            and set(want_opt) == set(got_opt)
            and all(torch.equal(want_opt[i][k], got_opt[i][k])
                    for i in want_opt for k in ("exp_avg", "exp_avg_sq")))
    layout = {i: {k: tuple(v.shape) for k, v in st.items()} for i, st in got_opt.items()}
    plain_layout = {i: {k: tuple(v.shape) for k, v in st.items()}
                    for i, st in plain_opt.items()}
    step2 = tt.make_train_step(net, tt.LossConfig(), SKEL, opt)
    losses = [_data_mean(s(st, x, y, 1e-3)["loss"], mesh)
              for s, st in ((step, state), (step2, fresh))]
    return {"same_state": same, "single_device_optimizer": layout == plain_layout,
            "losses": losses}


def task_pipeline(out: Path) -> dict:
    inp = torch.load(out / "inputs.pt", weights_only=False)
    inp["out"] = out
    results = {}
    # MLP stages: S = 4 on a 1 x 4 pipe mesh
    mesh4 = make_mesh(1, pipe=4)
    for m in (4, 8, 16):
        params = {k: v.clone().requires_grad_() for k, v in inp["mlp"].items()}
        x = inp["mlp_x"].clone().requires_grad_()
        y = pipeline_apply(_stage, params, x, mesh4, microbatches=m)
        (y ** 2).sum().backward()
        grads = {k: v.grad.clone() for k, v in params.items()}
        for g in grads.values():  # each stage's slice has its rank's gradient
            dist.all_reduce(g)
        results[f"mlp_{m}"] = [y.detach(), x.grad, grads]
    # the rMCL flagship, depth 4, on data 2 x pipe 2 with 2 microbatches
    mesh = make_mesh(2, pipe=2)
    cfg = inp["cfg"]
    net = make_pipelined_apply(_model(cfg, inp["weights"]), mesh, data_axis="data",
                               microbatches=2)
    x, y = shard_batch((inp["x"], inp["y"]), mesh)
    with torch.no_grad():
        poses, scores = net.eval()(x)
    results["rmcl_forward"] = [_gather_data(poses, mesh), _gather_data(scores, mesh)]
    net = shard_params(net.train(), mesh, "dp")
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6)
    opt.sharding = GradSync(net, opt.params)
    loss = tt.compute_loss(net(x), y, tt.LossConfig(), SKEL)[0]
    loss.backward()
    opt.sharding.reduce(opt.params)  # sum over pipe, mean over data
    results["rmcl_grads"] = full_grads(net)
    # fsdp_dp on the pipe mesh: two steps, the weights against one process
    plain = _model(cfg, inp["weights"])
    popt = tt.make_optimizer(plain.parameters(), weight_decay=1e-6)
    pstate = tt.TrainState.create(plain, popt, seed=0, device="cpu")
    pstep = tt.make_train_step(plain, tt.LossConfig(), SKEL, popt)
    net = shard_params(make_pipelined_apply(_model(cfg, inp["weights"]), mesh,
                                            data_axis="data", microbatches=2),
                       mesh, "fsdp_dp")
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6)
    opt.sharding = GradSync(net, opt.params)
    state = tt.TrainState.create(net, opt, seed=0, device="cpu")
    step = tt.make_train_step(net, tt.LossConfig(), SKEL, opt)
    for _ in range(2):
        pstep(pstate, inp["x"], inp["y"], 1e-3)
        step(state, x, y, 1e-3)
    results["fsdp_dp_params"] = [full_state_dict(net), full_state_dict(plain)]
    results["stages"] = _stage_holdings(net, mesh)
    results["pipe_resume"] = _pipe_resume(inp, mesh, state, step, x, y, pstate)
    # drop-path 0.2: two training steps
    net = shard_params(make_pipelined_apply(
        _model(dict(cfg, drop_path_rate=0.2), inp["weights"]), mesh, data_axis="data",
        microbatches=2), mesh, "dp")
    opt = tt.make_optimizer(net.parameters(), weight_decay=1e-6)
    opt.sharding = GradSync(net, opt.params)
    state = tt.TrainState.create(net, opt, seed=rank_seed(0, mesh), device="cpu")
    step = tt.make_train_step(net, tt.LossConfig(), SKEL, opt)
    results["drop_path_losses"] = [float(step(state, x, y, 1e-3)["loss"]) for _ in range(2)]
    # MixSTE with its head, and the manifold model, on the 1 x 4 pipe mesh
    mix = tm.MixSTE(tm.MixSTEConfig(**inp["mixste_cfg"]))
    mix.load_state_dict(inp["mixste_weights"], strict=True)
    manifold = tm.ManifoldMixSTE(tm.ManifoldConfig(**cfg), SKEL)
    manifold.load_state_dict(inp["manifold_weights"], strict=True)
    with torch.no_grad():
        results["mixste"] = make_pipelined_apply(mix, mesh4, microbatches=4).eval()(
            inp["mixste_x"])
        results["manifold"] = make_pipelined_apply(manifold, mesh4, microbatches=2).eval()(
            inp["x"])
    return results


def task_ring_factory(out: Path) -> dict:
    """``instantiate_model`` with model.attn_impl=ring and parallel.model=2
    (the factory test's settings): the ring on the temporal blocks only, and
    a finite forward."""
    from manipose_tpu_torch.config import load_config
    from manipose_tpu_torch.drivers import instantiate_model

    cfg = load_config("config", [
        "data.seq_len=9", "model.layers=2", "model.channels=32", "model.nheads=4",
        "model.layers_seg=2", "model.channels_seg=16", "model.nheads_seg=4",
        "multi_hyp.n_hyp=2", "model.attn_impl=ring", "parallel.model=2"])
    model, _ = instantiate_model(cfg, SKEL, mesh=mesh_from_config(cfg, "cpu"))
    trunk = model.rotations_module
    with torch.no_grad():
        poses, _ = model.eval()(torch.randn(2, 9, 17, 2, generator=torch.Generator()
                                            .manual_seed(0)))
    return {"attn_impl": trunk.cfg.attn_impl, "ring_axis": trunk.cfg.ring.axis,
            "temporal_ring": all(b.attn.ring is not None for b in trunk.TTEblocks),
            "spatial_ring": any(b.attn.ring is not None for b in trunk.STEblocks),
            "poses": poses.numpy()}


TASKS = {"parallel": task_parallel, "pipeline": task_pipeline,
         "ring_factory": task_ring_factory}


def main() -> None:
    task, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    initialize_multihost(auto=True, backend="gloo")
    try:
        results = TASKS[task](out)
        if dist.get_rank() == 0:
            torch.save(copy.deepcopy(results), out / "results.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
