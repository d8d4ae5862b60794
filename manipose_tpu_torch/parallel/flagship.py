"""GPipe pipelining of the MixSTE trunk (config: ``parallel.pipe``).

Port of ``manipose_tpu/parallel/flagship.py:47-355``. The depth-D trunk
of the model's rotations branch splits into S stages of D/S (spatial,
temporal) block pairs, one stage a rank of the ``pipe`` group, scheduled
by :func:`~.pipeline.run_pipeline`; each data shard runs its own
pipeline.

- The embedding and the spatial positional add run before the pipeline,
  on every rank (only stage 0 reads their result). The head, the MCL
  heads, the segments branch and FK run after it, on every rank, on the
  result the pipeline leaves on every rank.
- The temporal positional table goes in before the first temporal block
  only (pair 0), and each block keeps its own drop-path rate, as in the
  JAX version's stacked stage data.
- The module holds the model's own parameters, under their own names, and
  each rank keeps the blocks of its stage alone, as the JAX version keeps
  1/S of the stacked blocks on each device: the other stages' block
  parameters stay in the module as empty placeholders (``pipe_owner``
  names every block parameter's stage), so they take no memory, no
  gradient and no optimizer state on this rank, and the names and the
  optimizer's parameter order stay those of the single-device model.
  Checkpoints gather each stage's blocks from its rank
  (``mesh.full_state_dict``) into the single-device layout.
- A stage's blocks get their whole gradient on its own rank. The tied
  post-block norms get a part on every rank, the embedding and the
  positional tables theirs on stage 0: ``pipe_summed`` names these shared
  trunk parameters, whose gradients the train step sums over ``pipe`` (the
  JAX version's ``broadcast_to`` VJP for the norms), after which every
  rank makes the same update of them. The head, the segments branch and
  the MCL heads run on every rank after the pipeline's sum and already
  hold their whole gradient there; summing them would count them S times.
- Drop-path masks: every rank draws the masks of every block for every
  microbatch, in one order, from the trunk's generator, and uses its own
  stage's; so the generator ends every forward in the same state on every
  rank of ``pipe``, and the segments branch draws the same masks on all of
  them, as its replicated computation needs.
- The rMCL rotations trunk runs without muP, the reference's quirk kept
  by ``models/rmcl.py`` (``flagship.py:269-271``).
- The JAX version asserts ``drop_rate == 0``: the port's MixSTE has no
  positional dropout at all. Its ``attn_impl == "xla"`` assertion chooses
  nothing here: inside the stages the port's kernels (K1-K6) run on every
  CUDA tensor, as everywhere else. The stages run the fold layout whatever
  ``layout`` says, and without ``remat``, as the JAX stage program does.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .comm import group_rank, group_size
from .pipeline import run_pipeline


def _largest_divisor_leq(n: int, cap: int) -> int:
    m = max(1, min(cap, n))
    while n % m:
        m -= 1
    return m


def pick_microbatches(batch: int, data_size: int, requested: int) -> int:
    """Largest microbatch count <= ``requested`` that divides the
    per-data-shard batch (GPipe wants many; small batches clamp)."""
    if batch % data_size:
        raise ValueError(f"batch {batch} does not divide over {data_size} data shards")
    return _largest_divisor_leq(batch // data_size, requested)


def _draw_masks(trunk, mb: int, n_mb: int, length: int, joints: int) -> Optional[List]:
    """[microbatch][block][branch] -> (mask1, mask2), every block's, drawn
    in one order; None when drop-path is inactive."""
    if not trunk.training or trunk.cfg.drop_path_rate == 0.0:
        return None
    device = trunk.Spatial_pos_embed.device
    masks = []
    for _ in range(n_mb):
        per_block = []
        for i in range(trunk.cfg.depth):
            ste, tte = trunk.STEblocks[i].drop_path, trunk.TTEblocks[i].drop_path
            per_block.append((
                (ste.draw_shape((mb * length, 1, 1), device),
                 ste.draw_shape((mb * length, 1, 1), device)),
                (tte.draw_shape((mb * joints, 1, 1), device),
                 tte.draw_shape((mb * joints, 1, 1), device)),
            ))
        masks.append(per_block)
    return masks


def pipelined_trunk(trunk, x: torch.Tensor, mesh, pipe_axis: str,
                    microbatches: int) -> torch.Tensor:
    """(B, L, J, in) -> (B, L, J, C) features of the MixSTE ``trunk``
    through the staged pipeline over ``pipe_axis``."""
    cfg = trunk.cfg
    group = mesh.get_group(pipe_axis)
    n_stages, s = group.size(), group.rank()
    if cfg.depth % n_stages:
        raise ValueError(f"trunk depth {cfg.depth} must divide into parallel.pipe="
                         f"{n_stages} stages")
    pps = cfg.depth // n_stages
    b, length, joints, _ = x.shape
    if length != cfg.num_frame or joints != cfg.num_joints:
        raise ValueError(f"expected {cfg.num_frame} frames of {cfg.num_joints} joints, "
                         f"got {length} of {joints}")
    dt = cfg.dtype
    # ---- before the pipeline: embed + spatial positional table ----
    x = x.to(dt)
    if trunk.use_patch_embed:
        x = trunk.Spatial_patch_to_embedding(x)
    x = x + trunk.Spatial_pos_embed.to(dt)
    mb = b // microbatches
    masks = _draw_masks(trunk, mb, microbatches, length, joints)

    def stage(h, t):
        m_idx = t - s  # the microbatch this stage works on at tick t
        for j in range(pps):
            i = s * pps + j
            (m1, m2), (m3, m4) = (((None, None), (None, None)) if masks is None
                                  else masks[m_idx][i])
            n, l_, j_, c = h.shape
            z = trunk.STEblocks[i](h.reshape(n * l_, j_, c), m1, m2)
            h = trunk.Spatial_norm(z).reshape(n, l_, j_, c).transpose(1, 2)  # (B, J, L, C)
            if i == 0:
                h = h + trunk.Temporal_pos_embed.to(h.dtype)
            z = trunk.TTEblocks[i](h.reshape(n * j_, l_, c), m3, m4)
            h = trunk.Temporal_norm(z).reshape(n, j_, l_, c).transpose(1, 2)
        return h

    return run_pipeline(stage, x, group, microbatches, pass_tick=True)


def _head(trunk, feats: torch.Tensor) -> torch.Tensor:
    """The MixSTE head: LayerNorm (eps 1e-5), muP readout division, Linear."""
    norm, linear = trunk.head
    return linear(norm(feats) / trunk.cfg.readout_div)


class PipelinedModel(nn.Module):
    """``model`` with its rotations trunk GPipe-staged over ``pipe_axis``:
    called as the model is, with the model's own parameters (under the
    prefix ``model.``). See :func:`make_pipelined_apply`."""

    def __init__(self, model: nn.Module, mesh, pipe_axis: str = "pipe",
                 data_axis: Optional[str] = None, microbatches: int = 4):
        super().__init__()
        from ..models.manifold import ManifoldMixSTE
        from ..models.mix_ste import MixSTE
        from ..models.rmcl import RMCLManifoldMixSTE

        if isinstance(model, MixSTE):
            self.kind, trunk_prefix = "mixste", "model."
        elif isinstance(model, RMCLManifoldMixSTE):
            self.kind, trunk_prefix = "rmcl", "model.rotations_module."
        elif isinstance(model, ManifoldMixSTE):
            self.kind, trunk_prefix = "manifold", "model.rotations_module."
        else:
            raise TypeError(f"unsupported model type for pipelining: {type(model)}")
        if getattr(model.cfg, "quant", False):
            raise ValueError("the pipelined trunk trains; int8 (quant) models serve only")
        self.model = model
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis
        self.microbatches = microbatches
        trunk = model if self.kind == "mixste" else model.rotations_module
        group = mesh.get_group(pipe_axis)
        n_stages, stage = group_size(group), group_rank(group)
        if trunk.cfg.depth % n_stages:
            raise ValueError(f"trunk depth {trunk.cfg.depth} must divide into "
                             f"parallel.pipe={n_stages} stages")
        pps = trunk.cfg.depth // n_stages
        # {block parameter: its stage}; another stage's is an empty placeholder
        self.pipe_owner = {}
        for blocks in ("STEblocks", "TTEblocks"):
            for i, block in enumerate(getattr(trunk, blocks)):
                for pname, p in block.named_parameters():
                    self.pipe_owner[f"{trunk_prefix}{blocks}.{i}.{pname}"] = i // pps
                    if i // pps != stage:
                        p.data = p.data.new_empty(0)
        head = trunk_prefix + "head."
        self.pipe_summed = frozenset(
            name for name, _ in self.named_parameters()
            if name.startswith(trunk_prefix) and not name.startswith(head)
            and name not in self.pipe_owner)

    def _trunk_features(self, trunk, x):
        # each rank's batch is its own data shard: data_size 1 here
        mb = pick_microbatches(x.shape[0], 1, self.microbatches)
        return pipelined_trunk(trunk, x, self.mesh, self.pipe_axis, mb)

    def forward(self, x: torch.Tensor):
        from ..models.decoder import decode_poses

        model = self.model
        if self.kind == "mixste":
            feats = self._trunk_features(model, x)
            return _head(model, feats) if model.apply_head else feats
        rot = model.rotations_module
        feats = self._trunk_features(rot, x)
        if self.kind == "rmcl":
            preds, logits = rot.head(feats)
            scores = torch.softmax(logits, dim=1)
            lengths = model.segments_module(x)[:, None, None, :, 0]  # (B, 1, 1, S)
            roots = preds.new_zeros(preds.shape[:-2] + (3,))
            poses = decode_poses(preds, lengths, roots, model.skeleton,
                                 model.cfg.rot_rep_dim)
            return poses, scores
        rotations = _head(rot, feats)
        lengths = model.segments_module(x).transpose(1, 2)  # (B, 1, S)
        roots = rotations.new_zeros(rotations.shape[:-2] + (3,))
        return decode_poses(rotations, lengths, roots, model.skeleton,
                            model.cfg.rot_rep_dim)


def make_pipelined_apply(model: nn.Module, mesh, pipe_axis: str = "pipe",
                         data_axis: Optional[str] = None,
                         microbatches: int = 4) -> PipelinedModel:
    """Drop-in replacement for calling ``model`` (MixSTE, ManifoldMixSTE or
    RMCLManifoldMixSTE) with its rotations trunk GPipe-staged over
    ``pipe_axis`` of ``mesh``: a module whose parameters are the model's
    own, so checkpoints are unchanged. ``model`` keeps this rank's stage's
    blocks only (the others become empty placeholders): load its weights
    first. ``data_axis`` names the axis the
    batch is split over (each rank gets its own rows); the head, the
    segments branch and FK run after the pipeline on every rank."""
    return PipelinedModel(model, mesh, pipe_axis, data_axis, microbatches)


def maybe_pipelined_apply(model: nn.Module, cfg, mesh=None) -> nn.Module:
    """Driver hook: ``model`` itself, or its GPipe-staged form when the
    config asks for it (``parallel.pipe > 1``) on ``mesh``, the run's
    (data, pipe) mesh (``mesh.mesh_from_config``)."""
    pcfg = cfg.get("parallel") or {}
    if int(pcfg.get("pipe", 1)) <= 1:
        return model
    if int(pcfg.get("model", 1)) != 1:
        raise ValueError("parallel.pipe composes with data parallelism only "
                         "(set parallel.model=1)")
    if mesh is None or "pipe" not in mesh.mesh_dim_names:
        raise ValueError("parallel.pipe > 1 needs the run's (data, pipe) mesh: pass "
                         "mesh=parallel.mesh.mesh_from_config(cfg)")
    n_data = int(pcfg.get("data", 1))
    return make_pipelined_apply(model, mesh, data_axis="data" if n_data > 1 else None,
                                microbatches=int(pcfg.get("microbatches", 4)))
