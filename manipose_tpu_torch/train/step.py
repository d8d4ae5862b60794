"""Train and eval-loss steps.

Port of ``manipose_tpu/train/step.py``: forward (trunks + FK decode), the
composite loss, backward and the torch-semantics Adam update, with the
learning rate given per step by host-side schedules. The step returns its
metrics as 0-dim device tensors and never waits on the device, so steps
queue back to back; the caller reads a metric when it logs it.

On the card the trunks' attention and MLPs run the port's kernels forward
(K1, K3, K5) and backward (K2, K4, K6); on the CPU their plain versions
run. Drop-path masks come from the state's generator on the model's
device, never from torch's global RNG.

:func:`make_multi_train_step` is the megastep of
``manipose_tpu/train/step.py::make_multi_train_step``: K optimizer updates
in one call from a (K, B, ...) stack of batches, one learning rate for the
call, the metrics stacked (K,). On the card it is one ``torch.cuda.CUDAGraph``
of the K steps, captured once per (K, batch shape, dtype) and replayed:
the host launches one graph where K steps launched some 1500 kernels each.
On the CPU it runs the K steps eagerly.

The single step's spans (``utils.profiling``): ``step`` around the call,
and inside it ``step.forward`` (the model and the loss), ``step.backward``
and ``step.optimizer`` (the update). They time the host's enqueue of that
work, not the device's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .. import ops
from ..device import resolve_device
from ..geometry.skeleton import Skeleton
from ..models.mix_ste import set_drop_path_generator
from ..utils import profiling
from .losses import LossConfig, compute_loss
from .optim import Optimizer

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the drop-path generator and the count of
    steps taken."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer, seed: int = 0,
               device="cuda") -> "TrainState":
        """Move ``model`` to ``device`` (the card unless the caller asks
        for the CPU; its parameters stay the objects ``optimizer`` holds)
        and give its DropPath layers a generator there, seeded with
        ``seed``."""
        device = resolve_device(device)
        model.to(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        set_drop_path_generator(model, generator)
        return cls(model, optimizer, generator)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_train_step(
    model: nn.Module,
    loss_cfg: LossConfig,
    skeleton: Optional[Skeleton],
    optimizer: Optimizer,
    accum_steps: int = 1,
) -> Callable[..., Metrics]:
    """Build the train step for ``model`` and ``optimizer`` (those of the
    state it is given).

    Returns step(state, pose_2d, pose_3d, lr, n_valid=None) -> metrics.
    ``n_valid`` keeps only the leading rows (the de-duplicated part of a
    padded final batch). ``accum_steps > 1`` splits the batch into that
    many microbatches, sums their gradients and scales the sum by
    1/accum_steps before the one optimizer update, as the JAX step does; a
    batch that does not split evenly takes one single-shot gradient.
    """

    def loss_fn(pose_2d, pose_3d):
        with profiling.span("step.forward"):
            return compute_loss(model(pose_2d), pose_3d, loss_cfg, skeleton)

    def backward(total):
        with profiling.span("step.backward"):
            total.backward()

    def accumulate_grads(pose_2d, pose_3d):
        b = pose_2d.shape[0]
        if accum_steps == 1 or b % accum_steps:
            total, terms = loss_fn(pose_2d, pose_3d)
            backward(total)
            return total.detach(), {k: v.detach() for k, v in terms.items()}
        micro = b // accum_steps
        total, terms = None, None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            t, ts = loss_fn(pose_2d[rows], pose_3d[rows])
            backward(t)  # gradients sum over microbatches
            ts = {k: v.detach() for k, v in ts.items()}
            if total is None:
                total, terms = t.detach(), ts
            else:
                total = total + t.detach()
                terms = {k: terms[k] + v for k, v in ts.items()}
        inv = 1.0 / accum_steps
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.mul_(inv)
        return total * inv, {k: v * inv for k, v in terms.items()}

    def step(state: TrainState, pose_2d, pose_3d, lr: float,
             n_valid: Optional[int] = None) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer")
        with profiling.span("step"):
            device = _device(model)
            pose_2d = torch.as_tensor(pose_2d).to(device)
            pose_3d = torch.as_tensor(pose_3d).to(device)
            if n_valid is not None:
                pose_2d, pose_3d = pose_2d[:n_valid], pose_3d[:n_valid]
            model.train()
            optimizer.zero_grad()
            total, terms = accumulate_grads(pose_2d, pose_3d)
            with profiling.span("step.optimizer"):
                optimizer.step(lr)
            state.step += 1
            return {"loss": total, **terms}

    return step


@dataclasses.dataclass
class _Captured:
    """One captured megastep: its graph, its static inputs and metrics, the
    launches its capture recorded (``ops.launches_since``), and the
    learning-rate tensors it reads."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    y: torch.Tensor
    metrics: Metrics
    launches: dict
    lrs: tuple


class MultiTrainStep:
    """K train steps in one call; see :func:`make_multi_train_step`."""

    def __init__(self, model: nn.Module, loss_cfg: LossConfig,
                 skeleton: Optional[Skeleton], optimizer: Optimizer, n_steps: int):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.model, self.loss_cfg, self.skeleton = model, loss_cfg, skeleton
        self.optimizer, self.n_steps = optimizer, n_steps
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0  # graphs captured so far
        self.replays = 0  # calls that replayed one

    def _body(self, pose_2d, pose_3d) -> Metrics:
        """One optimizer step on one batch: device work only."""
        self.optimizer.zero_grad()
        total, terms = compute_loss(self.model(pose_2d), pose_3d, self.loss_cfg,
                                    self.skeleton)
        total.backward()
        self.optimizer.apply()
        return {"loss": total.detach(), **{k: v.detach() for k, v in terms.items()}}

    def __call__(self, state: TrainState, x_stack, y_stack, lr: float) -> Metrics:
        if state.model is not self.model or state.optimizer is not self.optimizer:
            raise ValueError("the state holds another model or optimizer")
        device = _device(self.model)
        x_stack, y_stack = torch.as_tensor(x_stack), torch.as_tensor(y_stack)
        if x_stack.shape[0] != self.n_steps or y_stack.shape[0] != self.n_steps:
            raise ValueError(f"stacked batches lead with {x_stack.shape[0]} steps, the "
                             f"megastep takes {self.n_steps}")
        self.model.train()
        self.optimizer.set_lr(lr)
        if device.type == "cpu":
            steps = [self._body(x_stack[i], y_stack[i]) for i in range(self.n_steps)]
            state.step += self.n_steps
            return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        lrs = tuple(g["lr"] for g in self.optimizer.adam.param_groups)
        key = (tuple(x_stack.shape), x_stack.dtype, tuple(y_stack.shape), y_stack.dtype)
        captured = self.graphs.get(key)
        if captured is None or any(a is not b for a, b in zip(captured.lrs, lrs)):
            captured = self.graphs[key] = self._capture(state, x_stack, y_stack, lrs)
        captured.x.copy_(x_stack, non_blocking=True)
        captured.y.copy_(y_stack, non_blocking=True)
        captured.graph.replay()
        ops.record_replay(captured.launches)
        self.replays += 1
        state.step += self.n_steps
        # the graph writes the same buffers at every replay
        return {k: v.clone() for k, v in captured.metrics.items()}

    def _capture(self, state: TrainState, x_stack, y_stack, lrs) -> _Captured:
        """Capture the K steps. One warm-up step first, on a side stream
        (it builds the kernels, settles their launch shapes and creates
        Adam's state), whose effects on the parameters, Adam's state, the
        skipped count and the generator are then undone; the drop-path
        generator is registered with the graph, so each replay draws fresh
        masks and advances it as K eager steps do."""
        device = _device(self.model)
        opt = self.optimizer
        x = torch.empty(x_stack.shape, dtype=x_stack.dtype, device=device)
        y = torch.empty(y_stack.shape, dtype=y_stack.dtype, device=device)
        x.copy_(x_stack)
        y.copy_(y_stack)
        with torch.no_grad():
            params = [p.detach().clone() for p in opt.params]
            adam = [None if t is None else tuple(v.clone() for v in t)
                    for t in opt._adam_tensors()]
            notfinite = opt._notfinite.clone()
        generator = state.generator.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body(x[0], y[0])
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for p, saved in zip(opt.params, params):
                p.copy_(saved)
            for now, saved in zip(opt._adam_tensors(), adam):
                for t, v in zip(now, saved or (None,) * 3):
                    if v is None:  # Adam's state began with the warm-up
                        t.zero_()
                    else:
                        t.copy_(v)
            opt._notfinite.copy_(notfinite)
        state.generator.set_state(generator)
        opt.zero_grad()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = ops.launch_snapshot()
        # thread-local capture: the prefetch thread may pin host memory meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            steps = [self._body(x[i], y[i]) for i in range(self.n_steps)]
            metrics = {k: torch.stack([m[k] for m in steps]) for k in steps[0]}
        self.captures += 1
        return _Captured(graph, x, y, metrics, ops.launches_since(before), lrs)


def make_multi_train_step(
    model: nn.Module,
    loss_cfg: LossConfig,
    skeleton: Optional[Skeleton],
    optimizer: Optimizer,
    n_steps: int,
) -> MultiTrainStep:
    """The megastep: ``n_steps`` optimizer updates in one call.

    Returns step(state, x_stack, y_stack, lr) -> metrics, where the stacks
    lead with the step axis (n_steps, B, ...) and every metric comes back
    stacked (n_steps,). The same updates as ``n_steps`` calls of
    :func:`make_train_step`'s step at ``lr``, with the drop-path generator
    advanced as they advance it. On the card the first call at a (batch
    shape, dtype) captures a CUDA graph of the K steps and every call
    replays it (a new shape captures anew); the generator is registered
    with the graph, so every replay draws new masks.
    """
    return MultiTrainStep(model, loss_cfg, skeleton, optimizer, n_steps)


def make_eval_loss_step(
    model: nn.Module,
    loss_cfg: LossConfig,
    skeleton: Optional[Skeleton],
) -> Callable[..., Metrics]:
    """Validation-loss step: deterministic forward (``model.eval()``), no
    gradients. Returns step(pose_2d, pose_3d, n_valid=None) -> metrics,
    computed on the leading ``n_valid`` rows (the padded final batch's
    de-duplicated part)."""

    def step(pose_2d, pose_3d, n_valid: Optional[int] = None) -> Metrics:
        device = _device(model)
        pose_2d = torch.as_tensor(pose_2d).to(device)[:n_valid]
        pose_3d = torch.as_tensor(pose_3d).to(device)[:n_valid]
        model.eval()
        with torch.no_grad():
            total, terms = compute_loss(model(pose_2d), pose_3d, loss_cfg,
                                        skeleton)
        return {"loss": total, **terms}

    return step
