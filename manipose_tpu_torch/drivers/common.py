"""Shared driver plumbing of the port: model factory, loaders, subject
splits.

Port of ``manipose_tpu/drivers/common.py``: ``instantiate_model`` for the
three architectures and, beyond the JAX package, MotionBERT's DSTformer
(``model=dstformer``, ``models/dstformer.py``), ``init_model_params``,
``get_subjects_and_actions`` and ``create_loader``, and
``maybe_restore_eval_params``. Without weights
the model gets the init ``model.init`` names (flax's by default, torch's
with ``model.init=torch``; ``train/init.py``) drawn from a
``torch.Generator`` seeded by ``cfg.run.seed``, so one seed gives the same
weights on every machine.
``model.dtype`` (``float32`` or ``bfloat16``) is the compute dtype; the
parameters are fp32 under both, so the init and the weight maps do not
depend on it. ``model.layout`` (``fold`` or ``joint_major``) is read as
the JAX package reads it (``manipose_tpu/drivers/common.py:38``).
``model.attn_impl=ring`` builds both trunks with ring temporal attention
over the run's (data, model) mesh, which the caller passes (``ring_spec``).
``model.remat=true`` (absent from ``configs/config.yaml``: false) builds
both trunks with ``remat``, which the JAX package sets in its model
configs only; it changes memory and time, not the math.
"""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path
from typing import Sequence

import torch
from torch import nn

from ..config import Config
from ..data import PoseSequenceDataset, SequenceLoader, fetch
from ..geometry.h36m import TEST_SUBJECTS, TRAIN_SUBJECTS
from ..geometry.skeleton import Skeleton
from ..models import (
    ManifoldConfig,
    ManifoldMixSTE,
    MixSTE,
    MixSTEConfig,
    RMCLManifoldMixSTE,
)
from ..train.init import init_from_config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(m: Config) -> torch.dtype:
    """``model.dtype`` as a torch dtype (the activations' type)."""
    name = m.get("dtype", "float32")
    if name not in _DTYPES:
        raise ValueError(f"model.dtype={name} is not one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def ring_spec(cfg: Config, mesh=None):
    """The ``RingSpec`` of ``model.attn_impl=ring`` on ``mesh``, else None.
    The frame axis splits over the mesh's ``model`` axis (so the parameters
    are not tensor-parallel there: ``train/loop.py`` switches the mode to
    dp), and that needs ``parallel.model > 1``
    (``manipose_tpu/drivers/common.py:40-55``) and the run's (data, model)
    mesh (``parallel.mesh.mesh_from_config``). The other JAX kernel knobs
    (attn_impl, mlp_impl) choose nothing in the port: on the card every
    other attention and MLP runs the port's kernels; attn_impl is still
    read by the joint-major refusal, as in the JAX package."""
    if cfg.model.get("attn_impl", "xla") != "ring":
        return None
    from ..parallel import RingSpec

    if int((cfg.get("parallel") or {}).get("model", 1)) <= 1:
        raise ValueError("model.attn_impl=ring shards the sequence over the 'model' "
                         "mesh axis; set parallel.model > 1")
    if mesh is None or "model" not in mesh.mesh_dim_names:
        raise ValueError("model.attn_impl=ring needs the run's (data, model) mesh: pass "
                         "mesh=parallel.mesh.mesh_from_config(cfg)")
    return RingSpec(mesh=mesh, axis="model", batch_axis="data")


def instantiate_model(cfg: Config, skeleton: Skeleton, quant: bool = False, mesh=None):
    """Model factory. Returns (module on the CPU, is_rmcl). ``quant=True``
    builds the int8 serving variant (``ops/quant.py``), whose quantized
    layers hold zeros until a quantized state dict is loaded. ``mesh``: the
    run's mesh, which ``model.attn_impl=ring`` needs."""
    m = cfg.model
    ring = ring_spec(cfg, mesh)
    dtype = compute_dtype(m)
    layout = m.get("layout", "fold")
    attn_impl = m.get("attn_impl", "xla")
    remat = bool(m.get("remat", False))
    if m.arch == "dstformer":
        if quant or ring is not None or remat or layout != "fold" or m.drop_path_rate:
            raise ValueError("model.arch=dstformer runs the fold layout in fp32 or bf16 "
                             "without drop-path: no int8, ring attention, remat or "
                             "joint-major layout")
        return _dstformer(cfg, skeleton, dtype), False
    if m.arch == "mixste":
        model = MixSTE(
            MixSTEConfig(
                num_frame=cfg.data.seq_len,
                num_joints=skeleton.num_joints,
                in_chans=2,
                out_dim=3,
                num_heads=m.nheads,
                depth=m.layers,
                embed_dim=m.channels,
                drop_path_rate=m.drop_path_rate,
                mup=m.mup,
                dtype=dtype,
                quant=quant,
                layout=layout,
                remat=remat,
                attn_impl=attn_impl,
                ring=ring,
            )
        )
        rmcl = False
    else:
        manifold_cfg = ManifoldConfig(
            num_frame=cfg.data.seq_len,
            num_joints=skeleton.num_joints,
            num_bones=skeleton.num_bones,
            in_chans=2,
            rot_rep_dim=m.rot_dim,
            num_heads_rot=m.nheads,
            depth_rot=m.layers,
            embed_dim_rot=m.channels,
            num_heads_seg=m.nheads_seg,
            depth_seg=m.layers_seg,
            embed_dim_seg=m.channels_seg,
            drop_path_rate=m.drop_path_rate,
            n_hyp=cfg.multi_hyp.n_hyp,
            mup=m.mup,
            dtype=dtype,
            quant=quant,
            layout=layout,
            remat=remat,
            attn_impl=attn_impl,
            ring=ring,
        )
        if m.arch == "manifold":
            model, rmcl = ManifoldMixSTE(manifold_cfg, skeleton), False
        elif m.arch == "rmcl_manifold":
            model, rmcl = RMCLManifoldMixSTE(manifold_cfg, skeleton), True
        else:
            raise ValueError(
                "Only MixSTE, Manifold-MixSTE, RMCL-Manifold-MixSTE and DSTformer "
                f"implemented for now. Got option {m.arch}."
            )
    return init_from_config(model, cfg), rmcl


def _dstformer(cfg: Config, skeleton: Skeleton, dtype: torch.dtype):
    """MotionBERT's DSTformer (``model=dstformer``: ``layers`` is its depth,
    ``channels`` its dim_feat), with MotionBERT's own init from
    ``cfg.run.seed`` (``model.init`` is not read)."""
    from ..models.dstformer import DSTformer, DSTformerConfig

    m = cfg.model
    model = DSTformer(DSTformerConfig(
        num_joints=skeleton.num_joints, maxlen=m.get("maxlen", cfg.data.seq_len),
        in_chans=m.get("in_chans", 3), embed_dim=m.channels, dim_rep=m.get("dim_rep", 512),
        depth=m.layers, num_heads=m.nheads, mlp_ratio=m.get("mlp_ratio", 2.0), dtype=dtype))
    return model.init_weights(cfg.run.seed)


def init_model_params(model: nn.Module, cfg: Config) -> nn.Module:
    """The model's initialized parameters, which is the model itself:
    ``instantiate_model`` has drawn them already (by ``model.init``, from
    ``cfg.run.seed``), and drawing them again would give the same weights.
    Kept so that the drivers call it where the JAX package's do."""
    del cfg
    return model


def maybe_restore_eval_params(model: nn.Module, cfg: Config) -> nn.Module:
    """Eval-only restore of the port's own checkpoints: with
    ``run.train=false``, ``run.checkpoint_params=<run dir>/<tag>`` loads
    that tag's ``model.pth`` into ``model`` (``run.checkpoint_model`` takes
    reference ``.pth`` files; with training on, ``run.checkpoint_params``
    resumes instead)."""
    path = cfg.run.get("checkpoint_params", "")
    if cfg.run.train or not path:
        return model
    from ..train.checkpoint import restore_checkpoint

    tag_dir = Path(path)
    print(f"==> eval-only: restoring params from {tag_dir}")
    return restore_checkpoint(tag_dir.parent, tag_dir.name, model)


def get_subjects_and_actions(dataset, cfg: Config):
    """([train, valid, test] subjects, the action filter or None)."""
    if cfg.data.use_valid:
        subjects_train = list(TRAIN_SUBJECTS[:-1])
        subjects_val = list(TRAIN_SUBJECTS[-1:])
    else:
        subjects_train = list(TRAIN_SUBJECTS)
        subjects_val = []
    subjects_test = list(TEST_SUBJECTS)
    if cfg.data.data == "one":
        subjects_train = [subjects_train[0]]
    action_filter = (
        None if cfg.data.actions == "*" else cfg.data.actions.split(",")
    )
    if action_filter is not None:
        action_filter = [dataset.define_actions(a)[0] for a in action_filter]
    return [subjects_train, subjects_val, subjects_test], action_filter


def create_loader(
    keypoints,
    dataset,
    action_filter,
    subjects: Sequence[str],
    cfg: Config,
    train: bool = True,
) -> SequenceLoader:
    """Windows of ``cfg.data.seq_len`` frames of every camera of
    ``subjects`` and the actions kept by ``action_filter``: random starts,
    flips and shuffling at train time, sequential otherwise."""
    poses, poses_2d, _, cameras = fetch(subjects, dataset, keypoints, action_filter)
    ds = PoseSequenceDataset(
        poses,
        poses_2d,
        cameras,
        seq_len=cfg.data.seq_len,
        random_start=train,
        miss_type=cfg.data.miss_type,
        miss_rate=cfg.data.miss_rate,
        noise_sigma=cfg.data.noise_sigma,
        skeleton=dataset.skeleton,
        flip_probability=0.5 if (train and cfg.train.flip_aug) else 0.0,
    )
    return SequenceLoader(
        ds,
        batch_size=cfg.train.batch_size if train else cfg.train.batch_size_test,
        shuffle=train,
        seed=cfg.run.seed,
    )


@contextlib.contextmanager
def rank_output_dir(output_dir: Path):
    """``output_dir`` on the primary rank; on every other rank of a process
    group a temporary directory, removed afterwards: each rank runs the test
    protocol (its collectives need them all) and one writes its files."""
    from ..parallel.multihost import is_primary

    if is_primary():
        yield output_dir
        return
    with tempfile.TemporaryDirectory(prefix="manipose-rank-") as tmp:
        yield Path(tmp)
