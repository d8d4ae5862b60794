"""Device meshes and shardings (data, tensor and fully sharded parallelism).

Port of ``manipose_tpu/parallel/mesh.py:26-139``. JAX drives one mesh from
one controller and lets XLA insert the collectives; here there is one
process per device (``torchrun``) and a ``DeviceMesh`` over the process
group, with the JAX axis names: ``data`` splits the batch, ``model`` the
trunk's matmuls (or, under ``model.attn_impl=ring``, the frame axis), and
``pipe`` the trunk's depth (``parallel/flagship.py``). Each rank holds its
own rows of the batch (:func:`shard_batch`).

The parameter rules are the JAX package's, on the port's state-dict
names. A flax kernel is (in, out) and a torch ``weight`` is (out, in), so
the JAX ``P(None, "model")`` on ``attn/qkv/kernel`` is ``("model", None)``
here: it splits dim 0 of ``attn.qkv.weight``. A spec is a tuple with one
mesh axis (or None) per dim, from the first; ``()`` is whole.

:func:`shard_params` modes (``mesh.py:95-123``):

- ``dp``: every parameter whole; ``DistributedDataParallel`` over the
  ``data`` group averages the gradients.
- ``tp``: Megatron tensor parallelism over ``model``. Where the JAX mesh
  splits the qkv columns contiguously and lets XLA move the data, the port
  splits them by heads: the (3, heads, d) rows of ``attn.qkv.weight`` give
  each rank its heads of q, k and v, so K1/K3 see whole heads. proj and fc2
  are row-parallel, followed by an all-reduce; their biases are added once,
  after it. fc1 is column-parallel; K5/K6 run on the local slice of the
  hidden width. Then ``DistributedDataParallel`` over ``data``.
- ``fsdp_dp``: FSDP2 ``fully_shard`` over ``data``; each parameter is
  sharded on the dim :func:`fsdp_param_spec` names (its largest free dim
  that divides over ``data``). FSDP2 cannot keep one parameter of a
  sharded group whole, so those the JAX rule leaves whole are sharded on
  dim 0 (padded); the numbers are the same.
- ``fsdp``: ``tp``, then ``fully_shard`` over ``data``.

A rank's H/model heads keep the head dim, so the attention wrapper pads a
narrow head dim (``ops.cuda_attention.attention``) as it does for the
whole model.

On a (data, pipe) mesh the model is a ``PipelinedModel``, whose rank keeps
its stage's blocks only (the others are empty placeholders,
``Layout.foreign``): ``dp`` keeps what it holds whole and the train step
averages the gradients over ``data`` itself, after summing the shared
trunk parameters' over ``pipe``; ``fsdp_dp`` shards what it holds over
``data`` and the train step sums over ``pipe``.

The optimizer (``train/optim.py``) works on each rank's own parts of the
parameters (:class:`GradSync`): the global gradient norm sums each
parameter's squares over the group its parts are split over, and a step
is skipped as non-finite when any rank's gradients are. Checkpoints are
whole: :func:`full_state_dict` gathers the single-device state dict (every
rank takes part, each pipe stage giving its blocks; the primary rank
writes it), and
:func:`load_full_state_dict` puts one back on the mesh; the optimizer's
moments go the same way.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_map


def _launch_hint(n: int) -> str:
    return (f"launch {n} processes with torchrun --nproc-per-node {n} (or "
            "initialise a process group of that size first)")


def _device_type() -> str:
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def make_mesh(data: int, model: int = 1, pipe: int = 1,
              device_type: Optional[str] = None):
    """A (data, model) mesh, or (data, pipe) when ``pipe`` > 1, over the
    initialised process group, whose size must be data x model (x pipe);
    tensor and pipeline parallelism never share a mesh. The device type
    follows the group's backend (nccl: cuda, gloo: cpu) unless given."""
    if model > 1 and pipe > 1:
        raise ValueError("tensor and pipeline parallelism cannot share a mesh "
                         f"(model={model}, pipe={pipe})")
    second = max(model, pipe)
    n = data * second
    if not dist.is_initialized():
        raise ValueError(f"mesh {data}x{second} needs a process group of {n}: "
                         + _launch_hint(n))
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {data}x{second} needs {n} processes, the process group "
                         f"has {dist.get_world_size()}: " + _launch_hint(n))
    from torch.distributed.device_mesh import init_device_mesh

    axis = "pipe" if pipe > 1 else "model"
    return init_device_mesh(device_type or _device_type(), (data, second),
                            mesh_dim_names=("data", axis))


def mesh_from_config(cfg, device=None):
    """The one mesh of a run: (data, model), or (data, pipe), as
    ``cfg.parallel`` asks, over the process group (initialised here under
    ``torchrun``: ``multihost.require_world``), or None for one process.
    The drivers build it once and hand it to the model factory (ring
    attention), ``flagship.maybe_pipelined_apply`` and ``train``."""
    from .multihost import require_world

    if require_world(cfg, device) == 1:
        return None
    pcfg = cfg.get("parallel") or {}
    return make_mesh(data=int(pcfg.get("data", 1)), model=int(pcfg.get("model", 1)),
                     pipe=int(pcfg.get("pipe", 1)))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh`` (1 when the mesh has no such axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size}, as the JAX ``Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# state-dict name -> spec (Megatron TP on the trunk matmuls), in torch's
# (out, in) order: the JAX rules of manipose_tpu/parallel/mesh.py:51-59
_PARAM_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"attn\.qkv\.weight$", ("model", None)),
    (r"attn\.qkv\.bias$", ("model",)),
    (r"attn\.proj\.weight$", (None, "model")),
    (r"mlp\.fc1\.weight$", ("model", None)),
    (r"mlp\.fc1\.bias$", ("model",)),
    (r"mlp\.fc2\.weight$", (None, "model")),
)


def param_spec(name: str) -> tuple:
    """The tensor-parallel spec of the parameter ``name`` (``()``: whole)."""
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, name):
            return spec
    return ()


def _is_linear_weight(name: str, shape) -> bool:
    return len(shape) == 2 and name.endswith("weight")


def fsdp_param_spec(name: str, shape, data_size: int, use_tp: bool = True) -> tuple:
    """ZeRO-3 spec: on top of the tensor-parallel rule (``use_tp``), the
    largest still-free dim that divides over ``data`` is split over it.
    Dims are ranked in the flax order (a Linear weight's reversed), so ties
    go where the JAX rule sends them. One entry per dim."""
    shape = tuple(shape)
    spec = list(param_spec(name)) if use_tp else []
    spec += [None] * (len(shape) - len(spec))
    linear = _is_linear_weight(name, shape)
    flax_shape = shape[::-1] if linear else shape
    flax_spec = spec[::-1] if linear else spec
    if data_size > 1 and len(shape) >= 1:
        order = sorted(range(len(shape)), key=lambda i: -flax_shape[i])
        for i in order:
            if (flax_spec[i] is None and flax_shape[i] % data_size == 0
                    and flax_shape[i] >= data_size):
                flax_spec[i] = "data"
                break
    return tuple(flax_spec[::-1] if linear else flax_spec)


@dataclasses.dataclass(frozen=True)
class _TPSplit:
    """How one parameter is split over ``model``: along ``dim``, in
    contiguous chunks, or (``heads3``) by heads within each of q, k and v."""

    dim: int
    heads3: bool = False

    def local(self, full: torch.Tensor, group) -> torch.Tensor:
        n, r = dist.get_world_size(group), dist.get_rank(group)
        if self.heads3:
            parts = full.reshape(3, n, full.shape[0] // (3 * n), *full.shape[1:])
            return parts[:, r].reshape(-1, *full.shape[1:]).contiguous()
        return full.chunk(n, dim=self.dim)[r].contiguous()

    def full(self, local: torch.Tensor, group) -> torch.Tensor:
        n = dist.get_world_size(group)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=group)
        if self.heads3:
            parts = [p.reshape(3, -1, *p.shape[1:]) for p in parts]
            return torch.cat(parts, dim=1).reshape(-1, *local.shape[1:])
        return torch.cat(parts, dim=self.dim)


def _tp_splits(name: str) -> Optional[_TPSplit]:
    spec = param_spec(name)
    if not spec:
        return None
    dim = spec.index("model")
    return _TPSplit(dim, heads3=".attn.qkv." in name or name.startswith("attn.qkv."))


@dataclasses.dataclass
class Layout:
    """How a sharded model's parameters lie on the mesh. Names are those of
    the single-device state dict."""

    mesh: object
    mode: str
    tp: Dict[str, _TPSplit] = dataclasses.field(default_factory=dict)
    pipe_summed: frozenset = frozenset()
    # {block parameter of the pipelined trunk: the pipe stage that holds it}
    pipe_owner: Dict[str, int] = dataclasses.field(default_factory=dict)
    average_data: bool = False  # the train step averages gradients over data

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def foreign(self, name: str) -> bool:
        """Whether ``name`` is another pipe stage's block (a placeholder here)."""
        owner = self.pipe_owner.get(name)
        return owner is not None and owner != axis_index(self.mesh, "pipe")


def unwrap(net: nn.Module) -> nn.Module:
    """The module whose state dict is the single-device one: ``net`` without
    its ``DistributedDataParallel`` and ``PipelinedModel`` wrappers."""
    from torch.nn.parallel import DistributedDataParallel

    from .flagship import PipelinedModel

    if isinstance(net, DistributedDataParallel):
        net = net.module
    if isinstance(net, PipelinedModel):
        net = net.model
    return net


def layout_of(net: nn.Module) -> Optional[Layout]:
    """The layout :func:`shard_params` gave ``net``, or None."""
    return getattr(unwrap(net), "_parallel_layout", None)


def _apply_tp(base: nn.Module, group) -> Dict[str, _TPSplit]:
    """Replace every trunk block's attention and MLP parameters with this
    rank's part (module ``tp`` set to ``group``); returns the splits."""
    from ..models.mix_ste import Attention, Mlp
    from ..ops.quant import QuantLinear

    n = dist.get_world_size(group)
    splits = {}
    for mod_name, mod in base.named_modules():
        if isinstance(mod, QuantLinear):
            raise ValueError("tensor parallelism trains; int8 (quant) models serve only")
        if not isinstance(mod, (Attention, Mlp)):
            continue
        if isinstance(mod, Attention):
            if mod.num_heads % n:
                raise ValueError(f"{mod_name}: {mod.num_heads} heads do not split over "
                                 f"parallel.model={n}")
            mod.num_heads //= n
            subs = ("qkv", "proj")
        else:
            if mod.fc1.weight.shape[0] % n:
                raise ValueError(f"{mod_name}: hidden width {mod.fc1.weight.shape[0]} "
                                 f"does not split over parallel.model={n}")
            subs = ("fc1", "fc2")
        for sub in subs:
            for pname, p in list(getattr(mod, sub).named_parameters(recurse=False)):
                name = f"{mod_name}.{sub}.{pname}" if mod_name else f"{sub}.{pname}"
                split = _tp_splits(name)
                if split is None:
                    continue  # proj and fc2 biases: whole, added after the sum
                with torch.no_grad():
                    local = split.local(p.detach(), group)
                setattr(getattr(mod, sub), pname, nn.Parameter(local, p.requires_grad))
                splits[name] = split
        mod.tp = group
    return splits


def shard_params(module: nn.Module, mesh, mode: str = "tp") -> nn.Module:
    """Lay ``module`` (on its device already; a model or a
    ``PipelinedModel``) out on ``mesh`` by ``mode`` and return what to call:
    the module itself (changed in place) or its
    ``DistributedDataParallel`` wrapper. See the module docstring."""
    if mode not in ("tp", "fsdp", "dp", "fsdp_dp"):
        raise ValueError(f"unknown parallel.mode {mode!r}")
    from torch.nn.parallel import DistributedDataParallel

    from .flagship import PipelinedModel

    base = unwrap(module)
    pipelined = isinstance(module, PipelinedModel)
    if pipelined and mode in ("tp", "fsdp"):
        raise ValueError(f"mode={mode} needs a 'model' axis; a pipe mesh takes dp or fsdp_dp")
    data = axis_size(mesh, "data")
    tp = {}
    if mode in ("tp", "fsdp"):
        specs = {n: fsdp_param_spec(n, p.shape, data) for n, p in base.named_parameters()}
        tp = _apply_tp(base, mesh.get_group("model"))
    else:
        specs = {n: fsdp_param_spec(n, p.shape, data, use_tp=False)
                 for n, p in base.named_parameters()}
    layout = Layout(mesh, mode, tp, average_data=pipelined and mode == "dp")
    if pipelined:
        layout.pipe_summed = frozenset(n[len("model."):] for n in module.pipe_summed)
        layout.pipe_owner = {n[len("model."):]: s for n, s in module.pipe_owner.items()}
    base._parallel_layout = layout
    if mode.startswith("fsdp"):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {id(p): specs[n].index("data") for n, p in base.named_parameters()
                if "data" in specs[n]}

        def placement(param):
            dim = dims.get(id(param))
            return None if dim is None else Shard(dim)

        # the root too: a no-grad forward (validation) leaves it sharded, so
        # the state dict and the optimizer always see the sharded parameters;
        # other pipe stages' placeholders stay out
        foreign = {p for n, p in base.named_parameters() if layout.foreign(n)}
        fully_shard(module, mesh=mesh["data"], shard_placement_fn=placement,
                    reshard_after_forward=True, ignored_params=foreign or None)
        return module
    if pipelined:
        return module
    return DistributedDataParallel(base, process_group=mesh.get_group("data"))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t`` (its local tensor when ``t`` is a DTensor)."""
    if _is_dtensor(t):
        with torch.no_grad():
            return t.to_local()
    return t


class GradSync:
    """What the optimizer needs to know of a sharded model (see
    ``train/optim.py``): the reductions the train step makes itself, the
    group over which each parameter's local gradient is a part (a pipe
    stage's blocks: ``pipe``), and the group that decides a non-finite
    step."""

    def __init__(self, net: nn.Module, params):
        self.layout = layout_of(net)
        base = unwrap(net)
        names = {id(p): n for n, p in base.named_parameters()}
        self.names = [names[id(p)] for p in params]
        mesh = self.layout.mesh
        self.world = dist.group.WORLD
        groups = []
        for p, name in zip(params, self.names):
            axes = set()
            if _is_dtensor(p) and any(pl.is_shard() for pl in p.placements):
                axes.add("data")
            if name in self.layout.tp:
                axes.add("model")
            if name in self.layout.pipe_owner:
                axes.add("pipe")
            if not axes:
                groups.append(None)
            elif len(axes) == 1:
                groups.append(mesh.get_group(axes.pop()))
            else:  # data and model, or data and pipe: the whole mesh
                groups.append(self.world)
        self.norm_groups = groups

    def reduce(self, params) -> None:
        """The gradient reductions no wrapper makes: the pipelined trunk's
        shared parameters' summed over ``pipe``, then (``dp`` on a pipe
        mesh) every gradient this rank holds averaged over ``data``."""
        layout = self.layout
        if layout.pipe_summed:
            grads = []
            for p, name in zip(params, self.names):
                if name in layout.pipe_summed:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    grads.append(local_part(p.grad))
            _all_reduce_flat(grads, layout.group("pipe"))
        if layout.average_data and axis_size(layout.mesh, "data") > 1:
            grads = []
            for p, name in zip(params, self.names):
                if layout.foreign(name):
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(local_part(p.grad))
            _all_reduce_flat(grads, layout.group("data"), average=True)


def _all_reduce_flat(tensors, group, average: bool = False) -> None:
    """All-reduce ``tensors`` in place over ``group`` as one flat buffer a
    dtype."""
    n = dist.get_world_size(group)
    if n == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if average:
            flat /= n
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def shard_batch(tree, mesh):
    """This rank's rows of each tensor in ``tree`` (a tensor or a tuple or
    list of them): the leading axis split over ``data``, as the JAX
    ``P("data")`` placement; 0-dim entries are kept whole."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def place(x):
        x = torch.as_tensor(x)
        if x.dim() == 0 or n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not divide over data={n}")
        return x.chunk(n)[i]

    if isinstance(tree, (tuple, list)):
        return type(tree)(place(x) for x in tree)
    return place(tree)


def replicate(tree, mesh):
    """``tree`` as every rank holds it: each process has its own copy
    already, so nothing moves (the JAX ``P()`` placement)."""
    del mesh
    return tree


def rank_seed(seed: int, mesh) -> int:
    """The drop-path seed of this rank: the run's seed on data shard 0, a
    different one on each other data shard, the same across ``model`` and
    ``pipe`` (whose ranks compute the same rows)."""
    return int(seed) + 1_000_003 * axis_index(mesh, "data")


def _full(layout: Optional[Layout], name: str, t: torch.Tensor) -> torch.Tensor:
    if _is_dtensor(t):
        t = t.full_tensor()
    if layout is not None and name in layout.tp:
        t = layout.tp[name].full(t, layout.group("model"))
    return t


def _from_stages(layout: Layout, local: dict, stage_of) -> dict:
    """``local`` ({key: tensor or {name: tensor}}) with the entries of every
    pipe stage's blocks (``stage_of(key)``: the key's stage, or None) taken
    from the rank of that stage, in the order of ``local``'s keys (a
    collective over ``pipe``)."""
    keys = list(local)
    if not layout.pipe_owner or axis_size(layout.mesh, "pipe") == 1:
        return {k: local[k] for k in keys if local[k] is not None}
    me = axis_index(layout.mesh, "pipe")
    device = (torch.device("cuda", torch.cuda.current_device())
              if layout.mesh.device_type == "cuda" else torch.device("cpu"))
    mine = {k: tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, v)
            for k, v in local.items()
            if stage_of(k) == me and v is not None}
    parts = [None] * axis_size(layout.mesh, "pipe")
    dist.all_gather_object(parts, mine, group=layout.group("pipe"))
    out = {}
    for k in keys:
        stage = stage_of(k)
        if stage is None:
            if local[k] is not None:
                out[k] = local[k]
        elif k in parts[stage]:
            out[k] = tree_map(lambda t: t.to(device) if torch.is_tensor(t) else t,
                              parts[stage][k])
    return out


def full_state_dict(net: nn.Module) -> dict:
    """The single-device state dict of ``net``, whole on every rank (a
    collective where ``net`` is sharded: every rank calls it)."""
    base = unwrap(net)
    layout = layout_of(net)
    sd = base.state_dict()
    if layout is None:
        return sd
    sd = {k: None if layout.foreign(k) else _full(layout, k, v) for k, v in sd.items()}
    return _from_stages(layout, sd, layout.pipe_owner.get)


def full_grads(net: nn.Module) -> dict:
    """{name: gradient} of ``net``'s parameters that have one, in the
    single-device layout (a collective where ``net`` is sharded)."""
    layout = layout_of(net)
    grads = {n: None if p.grad is None or (layout is not None and layout.foreign(n))
             else _full(layout, n, p.grad) for n, p in unwrap(net).named_parameters()}
    if layout is None:
        return {n: g for n, g in grads.items() if g is not None}
    return _from_stages(layout, grads, layout.pipe_owner.get)


def _local(layout: Optional[Layout], name: str, full: torch.Tensor,
           like: torch.Tensor) -> torch.Tensor:
    """``full`` (single-device layout) as this rank's part, laid out as
    ``like`` (the parameter, or its optimizer state); another pipe stage's
    block stays ``like``, its placeholder."""
    if layout is not None and layout.foreign(name):
        return like
    if layout is not None and name in layout.tp:
        full = layout.tp[name].local(full, layout.group("model"))
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        # every rank holds the whole tensor: each keeps its own shard
        return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh,
                                 like.placements, src_data_rank=None)
    return full


def load_full_state_dict(net: nn.Module, state_dict: dict) -> None:
    """Load a single-device state dict into ``net``, each rank taking its
    part."""
    base = unwrap(net)
    layout = layout_of(net)
    if layout is None:
        base.load_state_dict(state_dict, strict=True)
        return
    current = base.state_dict()
    local = {k: _local(layout, k, v, current[k]) if k in current else v
             for k, v in state_dict.items()}
    base.load_state_dict(local, strict=True)


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _param_names(net: nn.Module, params) -> list:
    names = {id(p): n for n, p in unwrap(net).named_parameters()}
    return [names[id(p)] for p in params]


def full_optimizer_state(net: nn.Module, optimizer) -> dict:
    """``optimizer.adam.state_dict()`` with each parameter's moments in the
    single-device layout (a collective where ``net`` is sharded)."""
    sd = optimizer.adam.state_dict()
    layout = layout_of(net)
    if layout is None:
        return sd
    names = _param_names(net, optimizer.params)
    state = {i: ({k: (_full(layout, names[i], v) if k in _MOMENTS else v)
                  for k, v in sd["state"][i].items()} if i in sd["state"] else None)
             for i in range(len(names))}
    state = _from_stages(layout, state, lambda i: layout.pipe_owner.get(names[i]))
    return {**sd, "state": state}


def load_full_optimizer_state(net: nn.Module, optimizer, state_dict: dict) -> None:
    """Load a single-device optimizer state into ``optimizer``, each rank
    taking its part of the moments (none of another pipe stage's blocks)."""
    layout = layout_of(net)
    if layout is not None:
        names = _param_names(net, optimizer.params)
        state = {}
        for i, st in state_dict["state"].items():
            if layout.foreign(names[int(i)]):
                continue
            p = optimizer.params[int(i)]
            state[i] = {k: (_local(layout, names[int(i)], v, p) if k in _MOMENTS else v)
                        for k, v in st.items()}
        state_dict = {**state_dict, "state": state}
    optimizer.adam.load_state_dict(state_dict)
