from .mix_ste import Attention, Block, DropPath, MixSTE, MixSTEConfig, Mlp
from .manifold import BonesMixSTE, ManifoldConfig, ManifoldMixSTE
from .decoder import decode_poses
from .rmcl import (
    MCLHead,
    MCLHeads,
    RMCLManifoldMixSTE,
    RMCLRotMixSTE,
    aggregate_hypotheses,
    poses_from_hyp_idx,
)

__all__ = [
    "Attention",
    "Block",
    "DropPath",
    "MixSTE",
    "MixSTEConfig",
    "Mlp",
    "BonesMixSTE",
    "ManifoldConfig",
    "ManifoldMixSTE",
    "decode_poses",
    "MCLHead",
    "MCLHeads",
    "RMCLManifoldMixSTE",
    "RMCLRotMixSTE",
    "aggregate_hypotheses",
    "poses_from_hyp_idx",
]
