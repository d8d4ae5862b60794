"""Optimizer and learning-rate schedules.

Port of ``manipose_tpu/train/optim.py``:
- ``torch.optim.Adam(weight_decay=w)`` couples the decay into the gradient
  before the moment updates, as optax's ``add_decayed_weights`` followed
  by ``scale_by_adam`` does (not AdamW); ``train.optimizer=adamw`` (beyond
  the JAX package, for MotionBERT's fine-tuning) takes
  ``torch.optim.AdamW`` instead, whose decay multiplies the parameters by
  1 - lr * w before the Adam update and never enters the moments;
- ``grad_clip`` follows ``optax.clip_by_global_norm``: the gradients are
  scaled by max / |g| only when |g| >= max, with no epsilon on the norm;
- ``skip_nonfinite`` follows ``optax.apply_if_finite``: a step whose
  gradients hold a NaN or an infinity leaves the parameters, the Adam
  moments and Adam's step count untouched. The decision is a select on the
  device, so no step waits on it and a step can sit inside a CUDA graph;
  the count of skipped steps is a device tensor, read when asked for;
- the learning rate is written into the param groups before every step,
  by schedules that run on the host (stepped once per validation epoch, as
  in the reference); a group may carry a fixed multiplier of it (muP,
  ``train/mup.py``). On the card Adam runs with ``capturable=True`` and
  each group's learning rate is a 0-dim device tensor filled before the
  step (:meth:`Optimizer.set_lr`), so that a captured step reads the rate
  of its replay, not the one it was captured with; on the CPU it stays a
  float.

Under a mesh (``parallel.shard_params``) the parameters may be split over
ranks: FSDP2 DTensors over ``data``, tensor-parallel parts over
``model``. ``Optimizer.sharding`` (a ``parallel.mesh.GradSync``) then
makes the gradient reductions that no wrapper makes (the pipeline's),
the global norm of ``grad_clip`` sums each parameter's squares over the
group its parts lie on, as XLA's norm over a sharded tree does, and a
step is skipped when the gradients of any rank are not finite. Adam
itself runs on each rank's parts.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import local_part as _local


class Optimizer:
    """torch-semantics Adam (or, with ``decoupled``, AdamW) with a per-step
    learning rate, global-norm clipping and the non-finite-step guard of the
    JAX package. No path waits on the device: :meth:`set_lr` (host) and
    :meth:`apply` (device work only, capturable) make one :meth:`step`.
    Either way the torch optimizer is ``self.adam``, with Adam's state keys
    (``exp_avg``, ``exp_avg_sq``, ``step``).
    """

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 weight_decay: float = 1e-6, grad_clip: float = 0.0,
                 skip_nonfinite: bool = False,
                 lr_scales: Optional[Iterable[float]] = None,
                 decoupled: bool = False):
        params = list(params)
        scales = [1.0] * len(params) if lr_scales is None else list(lr_scales)
        if len(scales) != len(params):
            raise ValueError(f"{len(scales)} learning-rate scales for {len(params)} "
                             "parameters")
        # one Adam param group per distinct scale, in the order first seen;
        # each step sets a group's lr to the step's lr times its scale
        groups = {}
        for p, scale in zip(params, scales):
            if p.requires_grad:
                groups.setdefault(float(scale), []).append(p)
        self.params = [p for group in groups.values() for p in group]
        kind = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.adam = kind(
            [{"params": group, "lr_scale": scale} for scale, group in groups.items()],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self._notfinite = torch.zeros((), dtype=torch.int64)  # steps skipped
        self.sharding = None  # parallel.mesh.GradSync under a mesh

    @property
    def notfinite_count(self) -> int:
        """Steps skipped so far (waits for the device)."""
        return int(self._notfinite)

    @notfinite_count.setter
    def notfinite_count(self, value: int) -> None:
        self._notfinite = torch.tensor(int(value), dtype=torch.int64,
                                       device=self._notfinite.device)

    def _place(self) -> torch.device:
        """Follow the parameters' device: on the card Adam is capturable, its
        step counts and the learning rates are device tensors; on the CPU
        they are a CPU tensor and floats."""
        device = self.params[0].device
        cuda = device.type == "cuda"
        for group in self.adam.param_groups:
            if group["capturable"] != cuda:
                group["capturable"] = cuda
                for p in group["params"]:
                    st = self.adam.state.get(p)
                    if st and "step" in st:
                        st["step"] = st["step"].to(device if cuda else "cpu")
            lr = group["lr"]
            if cuda and not (torch.is_tensor(lr) and lr.device == device):
                group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=device)
            elif not cuda and torch.is_tensor(lr):
                group["lr"] = float(lr)
        if self._notfinite.device != device:
            self._notfinite = self._notfinite.to(device)
        return device

    def set_lr(self, lr: float) -> None:
        """Each group's learning rate for the next steps: ``lr`` times the
        group's scale (a fill of its device tensor on the card)."""
        self._place()
        for group in self.adam.param_groups:
            value = lr * group["lr_scale"]
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(value)
            else:
                group["lr"] = value

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def _grads(self):
        return [_local(p.grad) for p in self.params if p.grad is not None]

    def _global_norm(self, grads) -> torch.Tensor:
        if self.sharding is None:
            return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        # each parameter's squares summed over the group its parts lie on;
        # the groups in the order of the parameters (the same on every rank,
        # whichever parameters have a gradient here)
        groups = list(dict.fromkeys(self.sharding.norm_groups))
        sums = {g: torch.zeros((), dtype=torch.float32, device=grads[0].device)
                for g in groups}
        for p, group in zip(self.params, self.sharding.norm_groups):
            if p.grad is not None:
                sums[group] = sums[group] + torch.sum(_local(p.grad).float() ** 2)
        for group in groups:
            if group is not None:
                dist.all_reduce(sums[group], group=group)
        return torch.sqrt(sum(sums.values()))

    def clip(self, grads) -> None:
        """optax.clip_by_global_norm, in place: g / |g| * max where
        |g| >= max."""
        norm = self._global_norm(grads)
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip))

    def _adam_tensors(self):
        """Each parameter's Adam state as it stands: (exp_avg, exp_avg_sq,
        step), None before its first step."""
        out = []
        for p in self.params:
            st = self.adam.state.get(p)
            out.append(tuple(_local(st[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
                       if st else None)
        return out

    def apply(self):
        """Apply the accumulated gradients at the rate :meth:`set_lr` set:
        device work only. Returns True, or under ``skip_nonfinite`` a 0-dim
        bool device tensor, False where the step was skipped: then the
        parameters, Adam's moments and its step count are put back (a
        select on the device) and the skipped count goes up by one."""
        self._place()
        if self.sharding is not None:
            self.sharding.reduce(self.params)
        grads = self._grads()
        finite = None
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            if self.sharding is not None:  # skipped where any rank's is not
                flag = finite.to(torch.int32)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.sharding.world)
                finite = flag.bool()
            saved = [_local(p).detach().clone() for p in self.params]
            saved_state = [None if t is None else tuple(x.clone() for x in t)
                           for t in self._adam_tensors()]
        if self.grad_clip > 0.0:
            self.clip(grads)
        self.adam.step()
        if finite is None:
            return True
        with torch.no_grad():
            for p, old, new, old_state in zip(self.params, saved,
                                              self._adam_tensors(), saved_state):
                p = _local(p)
                p.copy_(torch.where(finite, p, old))
                if new is None:
                    continue
                for t, o in zip(new, old_state or (None,) * 3):
                    t.copy_(torch.where(finite, t, torch.zeros_like(t) if o is None else o))
            self._notfinite.add_((~finite).to(torch.int64))
        return finite

    def step(self, lr: float):
        """Apply the accumulated gradients at learning rate ``lr``
        (:meth:`set_lr`, then :meth:`apply`); returns what :meth:`apply`
        returns."""
        self.set_lr(lr)
        return self.apply()


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   weight_decay: float = 1e-6, grad_clip: float = 0.0,
                   skip_nonfinite: bool = False, decoupled: bool = False) -> Optimizer:
    """Adam (AdamW with ``decoupled``) whose learning rate is given at every
    step (the schedules run on the host). ``grad_clip > 0`` clips by global
    norm; ``skip_nonfinite`` skips a step whose gradients are not all
    finite."""
    return Optimizer(params, weight_decay, grad_clip, skip_nonfinite, decoupled=decoupled)


# train.optimizer -> whether its weight decay is decoupled
OPTIMIZERS = {"adam": False, "adamw": True}


def optimizer_from_config(model: torch.nn.Module, cfg) -> Optimizer:
    """The optimizer the JAX train loop builds from a Config
    (``manipose_tpu/train/loop.py:67-85``) for ``model``'s parameters:
    ``train.optimizer`` (``adam``, the JAX loop's and the default, or
    ``adamw``), ``train.weight_decay`` (1e-6 unless set, the JAX loop's
    fixed decay), ``train.grad_clip`` and ``train.skip_nonfinite`` (the
    guard for bf16 runs; off in ``configs/config.yaml``), and under
    ``model.mup=true`` muP's per-parameter learning rates
    (``train/mup.py``, MuAdam's coupled decay: not with ``adamw``)."""
    t = cfg.train
    kind = t.get("optimizer", "adam")
    if kind not in OPTIMIZERS:
        raise ValueError(f"train.optimizer={kind!r} is not one of {sorted(OPTIMIZERS)}")
    mup = cfg.model.get("mup", False)
    if mup and OPTIMIZERS[kind]:
        raise ValueError("model.mup=true takes train.optimizer=adam (MuAdam), not adamw")
    weight_decay = float(t.get("weight_decay", 1e-6))
    grad_clip = float(t.get("grad_clip", 0.0))
    skip_nonfinite = bool(t.get("skip_nonfinite", False))
    if mup:
        from .mup import make_mup_optimizer

        return make_mup_optimizer(
            model, width=cfg.model.channels,
            base_width=cfg.model.get("mup_base_width", 64), weight_decay=weight_decay,
            grad_clip=grad_clip, skip_nonfinite=skip_nonfinite)
    return make_optimizer(model.parameters(), weight_decay=weight_decay, grad_clip=grad_clip,
                          skip_nonfinite=skip_nonfinite, decoupled=OPTIMIZERS[kind])


def lr_decay(step: int, lr: float, decay_step: int, gamma: float) -> float:
    """Exponential step decay."""
    return lr * gamma ** (step / decay_step)


class CosineAnnealingLR:
    """torch ``CosineAnnealingLR`` (closed form), stepped per validation
    epoch."""

    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.t_max = t_max
        self.eta_min = eta_min
        self._step = 0

    @property
    def lr(self) -> float:
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * self._step / self.t_max))
            / 2
        )

    def step(self, metric: Optional[float] = None) -> None:
        self._step += 1

    def state_dict(self):
        return {"step": self._step}

    def load_state_dict(self, state):
        self._step = state["step"]


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(mode=min, threshold_mode=rel)``."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 11,
                 threshold: float = 0.1, min_lr: float = 0.0):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> None:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]


def make_scheduler(kind: str, base_lr: float, epochs: int = 200,
                   n_annealing: int = 1, lr_min: float = 0.0,
                   lr_patience: int = 11, lr_threshold: float = 0.1):
    """"cosine" or "plateau", with the reference's settings."""
    if kind == "cosine":
        return CosineAnnealingLR(base_lr, t_max=epochs // n_annealing,
                                 eta_min=lr_min)
    if kind == "plateau":
        return ReduceLROnPlateau(base_lr, factor=0.5, patience=lr_patience,
                                 threshold=lr_threshold, min_lr=lr_min)
    raise ValueError(
        f"Accepted lr_scheduler values are 'cosine' and 'plateau'. Got {kind}."
    )
