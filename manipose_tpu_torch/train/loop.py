"""Training orchestration: epochs, validation cadence, best-tag
checkpoints, host-side learning-rate schedules, resume.

Port of ``manipose_tpu/train/loop.py:35-447`` (the reference's ``train()``,
``hpe/main_h36m_lifting.py:212-508``), with its semantics:
- the scheduler steps once per validation epoch and is fed the best
  validation loss so far (monotone), not the epoch's;
- checkpoint tags best_val, best_mpjpe, best_oracle_mpjpe,
  best_ps_oracle_mpjpe and end; the best weights are in the model when it
  returns;
- a resume state is saved after the scheduler's step when the validation
  loss improved, and at the end; ``run.checkpoint_params`` or
  ``run.auto_resume`` resume from the newest committed one;
- MPJPE on the validation loader every ``mpjpe_epoch_interval`` epochs;
- the padded last batch trains and validates on its valid rows only.

Each step's metrics stay 0-dim device tensors and are read once an epoch,
so the steps queue back to back on the card (``train.skip_nonfinite``
reads one flag a step). Batches are assembled, and for the card pinned,
on the prefetch thread. The best weights are a copy taken on the device
when an epoch is best: the optimizer updates the parameters in place.

Each epoch's log row adds, beside the JAX package's columns, the host
clock's split of the epoch (``epoch_seconds``: ``train_seconds`` to the
last step's metrics, ``valid_seconds``, ``mpjpe_seconds``,
``checkpoint_seconds`` on the launching thread) and, on the card, the
epoch's peak device memory (``peak_memory_gb``).

``train.steps_per_call = K > 1`` runs the megastep (``train/step.py``) as
the JAX loop does (``manipose_tpu/train/loop.py:188-206,268-330``): full
batches are buffered and every K of them flushed in one call (on the card
one CUDA-graph replay); a partial batch flushes what is pending and then
takes a single step, and the leftover of an epoch takes single steps, so
the data order stays the order of the optimizer's steps.

``parallel.data``, ``parallel.model`` and ``parallel.pipe`` above 1 train
on a mesh, as ``manipose_tpu/train/loop.py:87-128`` does, one process a
device (``torchrun``; the process group must have data x model x pipe
ranks, else a ValueError names the launch):

- the mesh is (data, model), or (data, pipe) for a ``PipelinedModel``
  (``parallel.maybe_pipelined_apply``, whose mesh is reused);
  ``parallel.mode`` (tp, fsdp, dp, fsdp_dp) lays the parameters out
  (``parallel.shard_params``), with tp and fsdp turned into dp and fsdp_dp
  under ring attention or a pipe, whose meshes give the ``model`` axis no
  matmuls to split;
- ``train.batch_size`` and ``train.batch_size_test`` must divide over
  ``data``; each rank trains and validates on its rows of every batch, the
  whole padded batch (the JAX loop keeps it for static shard shapes, so
  the padded last batch's repeated rows count in its loss), and the epoch's
  losses are averaged over ``data``;
- the MPJPE evaluation runs the whole valid loader on every rank;
- the megastep is off, with the JAX loop's note;
- drop-path draws from a generator a data shard
  (``parallel.mesh.rank_seed``);
- checkpoints hold the single-device layout; every rank takes part in the
  gathering and the primary rank writes them, the loss histories and the
  epoch lines.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..data.pipeline import SequenceLoader, prefetch
from ..device import resolve_device
from ..eval.engine import EvalConfig, evaluate
from ..geometry.skeleton import Skeleton
from ..parallel.mesh import (
    GradSync,
    axis_size,
    mesh_from_config,
    mesh_shape,
    rank_seed,
    shard_batch,
    shard_params,
)
from ..parallel.multihost import is_primary
from ..utils.logging import MetricLogger
from ..utils.profiling import ThroughputMeter, trace
from .checkpoint import (
    atomic_write_json,
    find_resume_state,
    prune_resume_states,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from .losses import LossConfig
from .optim import make_scheduler, optimizer_from_config
from .step import (
    TrainState,
    make_eval_loss_step,
    make_multi_train_step,
    make_train_step,
)


@dataclasses.dataclass
class TrainResult:
    best_mpjpe: float
    state: TrainState
    best_params: dict
    train_loss: list
    valid_loss: list


def _setup_mesh(net: nn.Module, cfg, device: torch.device, mesh):
    """(net laid out on ``mesh``, the mesh) as cfg.parallel says, or (net,
    None) for one process. Without ``mesh`` the run's mesh is built here."""
    if mesh is None:
        mesh = mesh_from_config(cfg, device)
    if mesh is None:
        return net, None
    pcfg = cfg.get("parallel") or {}
    n_data = axis_size(mesh, "data")
    cfg_train = cfg.train
    # every batch that is placed (train and validation) splits over data
    for name, bs in (("train.batch_size", cfg_train.batch_size),
                     ("train.batch_size_test",
                      cfg_train.get("batch_size_test", cfg_train.batch_size))):
        if bs % n_data:
            raise ValueError(f"{name}={bs} must divide over the data mesh axis ({n_data})")
    mode = pcfg.get("mode", "tp")
    if cfg.model.get("attn_impl", "xla") == "ring" or axis_size(mesh, "pipe") > 1:
        # ring gives the 'model' axis the sequence and a pipe mesh has no
        # 'model' axis: the matmuls stay whole (dp) or ZeRO-3 over data only
        mode = {"tp": "dp", "fsdp": "fsdp_dp"}.get(mode, mode)
    net = shard_params(net.to(device), mesh, mode=mode)
    if is_primary():
        print(f"==> Training on mesh {mesh_shape(mesh)}, mode={mode}")
    return net, mesh


def _data_mean(values: dict, mesh) -> dict:
    """``values`` ({name: float}) averaged over the data shards."""
    if mesh is None or axis_size(mesh, "data") == 1 or not values:
        return values
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    t = torch.tensor(list(values.values()), dtype=torch.float64, device=device)
    dist.all_reduce(t, group=mesh.get_group("data"))
    return dict(zip(values, (t / axis_size(mesh, "data")).tolist()))


def _snapshot(model: nn.Module) -> dict:
    """A copy of the model's weights, on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _means(sums: dict) -> dict:
    """{name: mean of its 0-dim tensors, as a float}: one transfer."""
    if not sums:
        return {}
    means = torch.stack([torch.stack(v).double().mean() for v in sums.values()])
    return dict(zip(sums, means.tolist()))


def train(
    model: nn.Module,
    cfg,
    skeleton: Skeleton,
    train_loader: SequenceLoader,
    valid_loader: SequenceLoader,
    output_dir,
    rmcl: bool,
    logger: Optional[MetricLogger] = None,
    start_epoch: int = 0,
    save_checkpoints: bool = True,
    device="cuda",
    mesh=None,
) -> TrainResult:
    """Train ``model`` (moved to ``device``, the card unless the caller asks
    for the CPU) as ``cfg`` (the full Config) says, and leave the best
    weights in it. Under ``parallel`` settings above 1 ``model`` (or the
    ``PipelinedModel`` of ``parallel.maybe_pipelined_apply``) is laid out
    on the mesh in place and the returned state holds what the steps call
    (see the module docstring). ``mesh``: the run's mesh, the one the model
    was built on (ring attention, the pipeline); built here when None."""
    device = resolve_device(device)
    model, mesh = _setup_mesh(model, cfg, device, mesh)
    output_dir = Path(output_dir)
    primary = is_primary()
    if primary:
        output_dir.mkdir(parents=True, exist_ok=True)
    logger = logger or MetricLogger()
    cfg_train = cfg.train

    optimizer = optimizer_from_config(model, cfg)
    seed = cfg.run.seed
    if mesh is not None:
        optimizer.sharding = GradSync(model, optimizer.params)
        seed = rank_seed(seed, mesh)
    state = TrainState.create(model, optimizer, seed=seed, device=device)
    scheduler = make_scheduler(
        cfg_train.lr_scheduler,
        base_lr=cfg_train.lr,
        epochs=cfg_train.epochs,
        n_annealing=cfg_train.n_annealing,
        lr_min=cfg_train.lr_min,
        lr_patience=cfg_train.lr_patience,
        lr_threshold=cfg_train.lr_threshold,
    )

    resume_from = cfg.run.get("checkpoint_params", "")
    if not resume_from and cfg.run.get("auto_resume", False):
        # relaunching the same command after a preemption picks up this
        # run's own newest committed resume state
        if find_resume_state(output_dir) is not None:
            resume_from = str(output_dir)
            print(f"==> auto_resume: found train state in {output_dir}")
    if resume_from:
        resume_dir = Path(resume_from)
        found = find_resume_state(resume_dir)
        if found is None:
            raise FileNotFoundError(
                f"no committed resume state under {resume_dir} (expected "
                "train_state_NNNNNN/ with host_state.json)"
            )
        tag, host = found
        restore_checkpoint(resume_dir, tag, state)
        scheduler.load_state_dict(host["scheduler"])
        start_epoch = host["epoch"]
        print(f"Resumed training state from {resume_dir}/{tag} @ epoch {start_epoch}")

    loss_cfg = LossConfig(
        sq_loss=cfg_train.sq_loss,
        w_loss=cfg_train.w_loss,
        vel_loss=cfg_train.vel_loss,
        smooth_reg=cfg_train.smooth_reg,
        rmcl_score_reg=cfg_train.rmcl_score_reg,
        rigid_seg_reg=cfg_train.rigid_seg_reg,
        rmcl=rmcl,
        nmpjpe=float(cfg_train.get("nmpjpe", 0.0)),
    )
    train_step = make_train_step(model, loss_cfg, skeleton, state.optimizer)
    steps_per_call = int(cfg_train.get("steps_per_call", 1))
    multi_step = None
    if steps_per_call > 1:
        if mesh is not None:
            print("WARNING: train.steps_per_call > 1 is single-device only (stacked "
                  "batches are not mesh-sharded); megastep DISABLED for this mesh run")
        else:
            multi_step = make_multi_train_step(model, loss_cfg, skeleton,
                                               state.optimizer, steps_per_call)
            print(f"==> Megastep: {steps_per_call} optimizer steps per call")
    # DistributedDataParallel's forward machinery is for training; eval and
    # validation call the module it wraps (whole on every rank)
    eval_model = model.module if isinstance(model, DistributedDataParallel) else model
    val_step = make_eval_loss_step(eval_model, loss_cfg, skeleton)
    eval_cfg = EvalConfig(tta=cfg_train.tta, rmcl=rmcl, compute_oracle=rmcl)
    on_card = device.type == "cuda"

    def place(batch):
        """(pose_2d, pose_3d) of this rank: its rows under a mesh."""
        x2d, x3d, _ = batch.to_device(device)
        if mesh is None:
            return x2d, x3d
        return shard_batch((x2d, x3d), mesh)

    def batches(loader):
        # pinned on the prefetch thread for the card, so the launching
        # thread only queues the copies
        return prefetch((b.pin_memory() for b in loader) if on_card else loader)

    best_valid_loss = 1e10
    best_mpjpe = 1e10
    best_oracle = 1e10
    best_psoracle = 1e10
    # None until a validation or MPJPE epoch fires: if none ever does, the
    # final weights are returned (the initial ones would poison the test
    # protocol)
    best_params = None
    train_loss_hist, valid_loss_hist = [], []
    ckpt_seconds = 0.0

    def _ckpt(tag):
        nonlocal ckpt_seconds
        if not save_checkpoints:
            return
        t0 = time.perf_counter()
        save_checkpoint(output_dir, tag, model)  # every rank; the primary writes
        ckpt_seconds += time.perf_counter() - t0

    def _save_resume_state(epoch):
        """The whole train state for a resume, and the scheduler and the
        epoch to restart at (the reference's params{tag}.pth). Called after
        the epoch's scheduler step. The save blocks and the sidecar, the
        commit's marker, is written inside the committed directory after
        it, so a kill at any point leaves the new state whole and marked or
        the previous one the newest marked (``find_resume_state``)."""
        nonlocal ckpt_seconds
        if not save_checkpoints:
            return
        t0 = time.perf_counter()
        tag = f"train_state_{epoch:06d}"
        save_checkpoint(output_dir, tag, state, block=True)
        if primary:
            host = {"scheduler": scheduler.state_dict(), "epoch": epoch, "tag": tag}
            atomic_write_json(output_dir / tag / "host_state.json", host)
            atomic_write_json(output_dir / "train_state_host.json", host)
            prune_resume_states(output_dir, keep=2)
        ckpt_seconds += time.perf_counter() - t0

    with trace(cfg.run.get("profile_dir", "")):
        for epoch in range(start_epoch, cfg_train.epochs):
            t_epoch = time.perf_counter()
            ckpt_seconds = 0.0
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            meter = ThroughputMeter()
            train_loader.set_epoch(epoch)
            # --- train epoch ---
            term_sums: dict = {}
            pending: list = []  # full batches buffered for the megastep

            def record(metrics):
                for k, v in metrics.items():
                    term_sums.setdefault(k, []).extend(v.unbind(0) if v.dim() else [v])

            def flush():
                """The pending batches: one megastep call when there are K,
                else single steps (the epoch's leftover)."""
                if not pending:
                    return
                meter.step(sum(x.shape[0] for x, _ in pending))
                if len(pending) == steps_per_call:
                    record(multi_step(state, torch.stack([x for x, _ in pending]),
                                      torch.stack([y for _, y in pending]), scheduler.lr))
                else:
                    for x2d, x3d in pending:
                        record(train_step(state, x2d, x3d, scheduler.lr))
                pending.clear()

            for batch in batches(train_loader):
                n_valid = int(batch.valid.sum())
                x2d, x3d = place(batch)
                if multi_step is not None and n_valid == batch.batch_size:
                    pending.append((x2d, x3d))
                    if len(pending) == steps_per_call:
                        flush()
                    continue
                # a partial batch runs after the buffered full ones: the data
                # order is the optimizer's step order
                flush()
                meter.step(n_valid)
                # under a mesh the whole padded batch trains (static shards)
                record(train_step(
                    state, x2d, x3d, scheduler.lr,
                    n_valid if mesh is None and n_valid < batch.batch_size else None,
                ))
            flush()
            # waits for the epoch's last step
            terms = _data_mean(_means(term_sums), mesh)
            seq_per_sec = meter.seq_per_sec
            t_train = time.perf_counter() - t_epoch
            epoch_loss = terms.pop("loss")
            train_loss_hist.append(epoch_loss)
            metrics_to_log = {"tr_loss": epoch_loss, "lr": scheduler.lr,
                              "seq_per_sec": seq_per_sec, **terms}
            timings = {"train_seconds": t_train, "valid_seconds": 0.0,
                       "mpjpe_seconds": 0.0}

            # --- validation loss ---
            if (epoch + 1) % cfg_train.valid_epoch_interval == 0:
                t0 = time.perf_counter()
                val_losses = []
                for batch in batches(valid_loader):
                    vx2d, vx3d = place(batch)
                    # under a mesh the whole padded batch, as in training
                    n_valid_val = None if mesh is not None else int(batch.valid.sum())
                    val_losses.append(val_step(vx2d, vx3d, n_valid_val)["loss"])
                epoch_val = (_data_mean(_means({"loss": val_losses}), mesh)["loss"]
                             if val_losses else np.inf)
                timings["valid_seconds"] = time.perf_counter() - t0
                valid_loss_hist.append(epoch_val)
                metrics_to_log["val_loss"] = epoch_val

                improved = best_valid_loss > epoch_val
                if improved:
                    best_valid_loss = epoch_val
                    _ckpt("best_val")
                    best_params = _snapshot(model)
                    metrics_to_log.update(
                        {"best_epoch_loss": epoch, "best_val_loss": epoch_val}
                    )
                # the reference steps the scheduler on validation epochs only
                # and feeds plateau the best loss
                scheduler.step(best_valid_loss)
                if improved:
                    _save_resume_state(epoch + 1)

            # --- MPJPE eval ---
            if (epoch + 1) % cfg_train.mpjpe_epoch_interval == 0:
                t0 = time.perf_counter()
                results = evaluate(eval_model, valid_loader, skeleton, eval_cfg)
                timings["mpjpe_seconds"] = time.perf_counter() - t0
                mpjpe_val = results[2]
                metrics_to_log["val_mpjpe"] = mpjpe_val
                if rmcl:
                    oracle_val, psoracle_val = results[3], results[4]
                    metrics_to_log["val_oracle_mpjpe"] = oracle_val
                    metrics_to_log["val_ps_oracle_mpjpe"] = psoracle_val
                    if best_oracle > oracle_val:
                        best_oracle = oracle_val
                        _ckpt("best_oracle_mpjpe")
                        metrics_to_log.update({"best_epoch_oracle_mpjpe": epoch,
                                               "best_val_oracle_mpjpe": oracle_val})
                    if best_psoracle > psoracle_val:
                        best_psoracle = psoracle_val
                        _ckpt("best_ps_oracle_mpjpe")
                        metrics_to_log.update({"best_epoch_ps_oracle_mpjpe": epoch,
                                               "best_val_ps_oracle_mpjpe": psoracle_val})
                if best_mpjpe > mpjpe_val:
                    best_mpjpe = mpjpe_val
                    _ckpt("best_mpjpe")
                    best_params = _snapshot(model)
                    metrics_to_log.update(
                        {"best_epoch_mpjpe": epoch, "best_val_mpjpe": best_mpjpe}
                    )

            metrics_to_log.update(timings, checkpoint_seconds=ckpt_seconds,
                                  epoch_seconds=time.perf_counter() - t_epoch)
            if on_card:
                metrics_to_log["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            if primary:
                print(f"epoch {epoch}: train loss {epoch_loss:.6f}, {seq_per_sec:.2f} "
                      f"sequences/s; " + ", ".join(
                          f"{k} {metrics_to_log[k]:.4f}" for k in (
                              "val_loss", "val_mpjpe", "train_seconds", "valid_seconds",
                              "mpjpe_seconds", "checkpoint_seconds", "epoch_seconds")
                          if k in metrics_to_log), flush=True)
            logger.log(metrics_to_log, step=epoch)

    _ckpt("end")
    _save_resume_state(cfg_train.epochs)
    if save_checkpoints:
        wait_for_checkpoints()  # every background write committed
    if primary:
        np.save(output_dir / "train_loss.npy", np.asarray(train_loss_hist))
        np.save(output_dir / "valid_loss.npy", np.asarray(valid_loss_hist))
    if best_params is None:
        print(
            "WARNING: no validation/eval epoch fired "
            f"(epochs={cfg_train.epochs}, valid_epoch_interval="
            f"{cfg_train.valid_epoch_interval}); returning FINAL params"
        )
        best_params = _snapshot(model)
    model.load_state_dict(best_params)  # the best weights, for the test protocol
    return TrainResult(
        best_mpjpe=best_mpjpe,
        state=state,
        best_params=best_params,
        train_loss=train_loss_hist,
        valid_loss=valid_loss_hist,
    )
