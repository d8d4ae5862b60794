"""Manifold-constrained MixSTE: rotations branch + segments branch + FK.

Port of ``manipose_tpu/models/manifold.py``. The rotations branch is a
MixSTE emitting one 6D/4D rotation per joint per frame; the segments
branch (BonesMixSTE) emits one length per bone per sequence (temporal
mean); forward kinematics puts every output pose on the
constant-bone-length manifold. ``ManifoldConfig.dtype`` (fp32 or bf16)
is both trunks' compute dtype, and ``ManifoldConfig.quant`` quantizes both
trunks' qkv, proj, fc1 and fc2 (int8 serving), as in the JAX package;
``layout`` and ``remat`` reach both trunks as the JAX package passes them
(``manipose_tpu/models/manifold.py:52,77,105``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..geometry.skeleton import Skeleton
from .decoder import decode_poses
from .mix_ste import Dense, MixSTE, MixSTEConfig


@dataclasses.dataclass(frozen=True)
class ManifoldConfig:
    num_frame: int = 243
    num_joints: int = 17
    num_bones: int = 16
    in_chans: int = 2
    rot_rep_dim: int = 6
    embed_dim_rot: int = 512
    depth_rot: int = 8
    num_heads_rot: int = 8
    embed_dim_seg: int = 128
    depth_seg: int = 2
    num_heads_seg: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_path_rate: float = 0.2
    n_hyp: int = 5  # used by the rMCL model only
    mup: bool = False
    mup_base_width: int = 64
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32
    quant: bool = False  # int8 serving in both trunks
    layout: str = "fold"  # both trunks' residual-stream layout (MixSTEConfig)
    remat: bool = False  # recompute both trunks' blocks in the backward pass
    attn_impl: str = "xla"  # "ring" runs ring temporal attention in both trunks
    ring: Optional[object] = None  # the RingSpec of attn_impl="ring"

    def _trunk(self, **kw) -> MixSTEConfig:
        return MixSTEConfig(
            num_frame=self.num_frame, in_chans=self.in_chans,
            mlp_ratio=self.mlp_ratio, qkv_bias=self.qkv_bias,
            qk_scale=self.qk_scale, drop_path_rate=self.drop_path_rate,
            mup=self.mup, mup_base_width=self.mup_base_width,
            dtype=self.dtype, quant=self.quant, layout=self.layout,
            remat=self.remat, attn_impl=self.attn_impl, ring=self.ring, **kw,
        )

    def rot_trunk_config(self) -> MixSTEConfig:
        return self._trunk(
            num_joints=self.num_joints, out_dim=self.rot_rep_dim,
            embed_dim=self.embed_dim_rot, depth=self.depth_rot,
            num_heads=self.num_heads_rot,
        )

    def seg_trunk_config(self) -> MixSTEConfig:
        # the segments trunk treats bones as its "joints"
        return self._trunk(
            num_joints=self.num_bones, out_dim=1,
            embed_dim=self.embed_dim_seg, depth=self.depth_seg,
            num_heads=self.num_heads_seg,
        )


class BonesMixSTE(MixSTE):
    """Segments branch: a joint->segment linear lifting replaces the patch
    embedding, then a small MixSTE trunk predicts one scalar per segment
    per frame, averaged over time. Its trunk parameters sit at the top of
    the module, as in the reference state dict."""

    def __init__(self, cfg: ManifoldConfig):
        super().__init__(cfg.seg_trunk_config(), use_patch_embed=False)
        self.num_bones = cfg.num_bones
        self.embed_dim_seg = cfg.embed_dim_seg
        self.joints_to_segments_proj = Dense(
            cfg.num_joints * cfg.in_chans, cfg.num_bones * cfg.embed_dim_seg,
            compute_dtype=cfg.dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, j, c = x.shape
        x = self.joints_to_segments_proj(x.reshape(b, l, j * c))
        x = x.reshape(b, l, self.num_bones, self.embed_dim_seg)
        return super().forward(x).mean(dim=1)  # (B, S, 1)


class ManifoldMixSTE(torch.nn.Module):
    """Single-hypothesis manifold model. (B, L, J, 2) -> (B, L, J, 3)."""

    def __init__(self, cfg: ManifoldConfig, skeleton: Skeleton):
        super().__init__()
        self.cfg = cfg
        self.skeleton = skeleton
        self.rotations_module = MixSTE(cfg.rot_trunk_config())
        self.segments_module = BonesMixSTE(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rotations = self.rotations_module(x)  # (B, L, J, rot)
        lengths = self.segments_module(x).transpose(1, 2)  # (B, 1, S)
        roots = rotations.new_zeros(rotations.shape[:-2] + (3,))
        return decode_poses(
            rotations, lengths, roots, self.skeleton, self.cfg.rot_rep_dim
        )
