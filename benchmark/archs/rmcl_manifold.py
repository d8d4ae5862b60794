"""The rMCL manifold model (``model.arch=rmcl_manifold``): its plain
reference, weights, loss, optimizer and yardstick.

Written from the model's published description (ManiPose, arXiv
2312.06386: two MixSTE trunks, K scored hypotheses, forward kinematics on
constant bone lengths) and the configuration file's sizes. It imports
nothing of the measured program.

Every architecture module (``archs/<model.arch>.py``, found by
``core.Cell.arch``) gives the harness this interface:

- ``shapes(cfg)``: (name, shape) of every parameter, under the reference
  implementation's state-dict names; ``draw(cfg, seed, device)``: the
  weights drawn from the seed (``harness.weights.draw``);
- ``forward(p, cfg, x, draws=None)``: the model on (B, L, J, 2) keypoints;
  ``lift_windows(p, cfg, x, tta)``: the served poses (B, L, J, 3);
  ``train_steps(p, cfg, batches, gens)``: the reference's training steps
  (``harness.reference.follow_steps`` with the architecture's loss and
  optimizer: ``harness.reference.Adam``, or one of its own);
- optionally ``port_loss_config(port_cfg, rmcl)``: the program's loss
  settings, where they are not what ``traffic/train_steps.py``'s
  ``port_loss_config`` builds (the port's ``LossConfig`` from its
  Config, as its training loop builds it for every model);
- ``model_flops(cfg, windows)``: matrix-product FLOPs of one forward;
  ``kernel_ops(cfg, windows, backward)``: {(operation, shape): calls};
- ``TINY``: {config group: {key: value}} that cut the model to a size the
  CPU runs in seconds (the benchmark's tests).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from harness import reference, weights, yardstick
from harness.reference import DropPathDraws, Params, layer_norm, linear

TINY = {"model": dict(layers=1, channels=32, nheads=2, layers_seg=1, channels_seg=16,
                      nheads_seg=2),
        "multi_hyp": {"n_hyp": 2}}


# ---- weights ----------------------------------------------------------------

def shapes(cfg: dict) -> List[Tuple[str, weights.Shape]]:
    """(name, shape) of every parameter of the rMCL manifold model."""
    m = cfg["model"]
    joints = len(cfg["skeleton"]["parents"])
    bones, frames = joints - 1, cfg["data"]["seq_len"]
    c, cs, ratio = m["channels"], m["channels_seg"], m.get("mlp_ratio", 2.0)
    rot = "rotations_module."
    out = [(rot + "Spatial_patch_to_embedding.weight", (c, 2)),
           (rot + "Spatial_patch_to_embedding.bias", (c,))]
    out += weights.mixste_trunk(rot, c, m["layers"], joints, frames, ratio)
    for h in range(cfg["multi_hyp"]["n_hyp"]):
        p = f"{rot}head.{h}."
        out += [(p + "norm.weight", (c,)), (p + "norm.bias", (c,)),
                (p + "prediction_head.weight", (m["rot_dim"] + 1, c)),
                (p + "prediction_head.bias", (m["rot_dim"] + 1,)),
                (p + "score_head.weight", (1, joints)), (p + "score_head.bias", (1,))]
    seg = "segments_module."
    out += weights.mixste_trunk(seg, cs, m["layers_seg"], bones, frames, ratio)
    out += [(seg + "head.0.weight", (cs,)), (seg + "head.0.bias", (cs,)),
            (seg + "head.1.weight", (1, cs)), (seg + "head.1.bias", (1,)),
            (seg + "joints_to_segments_proj.weight", (bones * cs, joints * 2)),
            (seg + "joints_to_segments_proj.bias", (bones * cs,))]
    return out


def _is_norm(name: str) -> bool:
    return "norm" in name or name.startswith("segments_module.head.0.")


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights for ``seed``, on ``device``, as a state dict.
    The heads read out as a trained model's do: the rotation heads about
    the identity rotation (bias) with a spread of a quarter of the rest's
    (weights), the segments head about a bone length of 0.25 m with a
    tenth, so that the poses are those of a body and the 6D vectors are
    far from degenerate."""
    rot_dim = cfg["model"]["rot_dim"]
    identity = torch.zeros(rot_dim + 1, device=device)
    identity[0] = identity[4] = 1.0

    def head(name, v):
        if name.endswith("prediction_head.bias"):
            return v + identity
        if name.endswith("prediction_head.weight"):
            return 0.25 * v
        if name == "segments_module.head.1.bias":
            return v + 0.25
        if name == "segments_module.head.1.weight":
            return 0.1 * v
        return v

    return weights.draw(shapes(cfg), seed, device, _is_norm, head)


# ---- model ------------------------------------------------------------------

def forward(p: Params, cfg: dict, x: torch.Tensor,
            draws: Optional[DropPathDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, J, 2) keypoints -> (poses (B, K, L, J, 3), scores (B, K, L, 1)).
    Drop-path masks are drawn for the rotations trunk, then the segments
    trunk."""
    m, skeleton = cfg["model"], cfg["skeleton"]
    b, l, j, _ = x.shape
    n_hyp = cfg["multi_hyp"]["n_hyp"]
    # rotations branch: K heads of LayerNorm -> Linear(C, 6 + 1); the last
    # channel of each joint feeds the head's score Linear(J, 1)
    r = linear(p, "rotations_module.Spatial_patch_to_embedding", x)
    r = r + p["rotations_module.Spatial_pos_embed"]
    feats = reference.mixste_trunk(p, "rotations_module.", r, m["layers"], m["nheads"], draws)
    preds, logits = [], []
    for h in range(n_hyp):
        pre = f"rotations_module.head.{h}."
        y = linear(p, pre + "prediction_head", layer_norm(p, pre + "norm", feats, 1e-5))
        preds.append(y[..., :-1])
        logits.append(linear(p, pre + "score_head", y[..., -1]))
    rep = torch.stack(preds, dim=1)  # (B, K, L, J, 6)
    scores = torch.softmax(torch.stack(logits, dim=1), dim=1)  # (B, K, L, 1)
    # segments branch: joints -> per-bone tokens, a small trunk, one length
    # a bone and frame, averaged over the frames
    s = linear(p, "segments_module.joints_to_segments_proj", x.reshape(b, l, j * 2))
    n_bones = len(skeleton["parents"]) - 1
    s = s.reshape(b, l, n_bones, m["channels_seg"]) + p["segments_module.Spatial_pos_embed"]
    s = reference.mixste_trunk(p, "segments_module.", s, m["layers_seg"], m["nheads_seg"],
                               draws)
    s = linear(p, "segments_module.head.1", layer_norm(p, "segments_module.head.0", s, 1e-5))
    lengths = s.mean(dim=1)[:, None, None, :, 0]  # (B, 1, 1, S)
    poses = reference.forward_kinematics(reference.rot6d_to_matrix(rep), lengths, skeleton)
    return poses, scores


def lift_windows(p: Params, cfg: dict, x: torch.Tensor, tta: bool = True) -> torch.Tensor:
    """Served poses of (B, L, J, 2) windows: the score-weighted mean of the
    hypotheses, averaged with the mirrored input's mirrored result."""
    poses, scores = forward(p, cfg, x)
    agg = torch.sum(poses * scores[..., None], dim=1)
    if tta:
        fp, fs = forward(p, cfg, reference.flip(x, cfg["skeleton"]))
        agg = (agg + reference.flip(torch.sum(fp * fs[..., None], dim=1), cfg["skeleton"])) / 2
    return agg


# ---- loss and optimizer -----------------------------------------------------

def loss_terms(poses: torch.Tensor, scores: torch.Tensor, target: torch.Tensor,
               train: dict) -> Dict[str, torch.Tensor]:
    """The rMCL training loss's terms. poses (B, K, L, J, 3), scores
    (B, K, L, 1), target (B, L, J, 3). Winner-takes-all of the
    joint-weighted MPJPE over the K hypotheses; the scores' binary cross
    entropy (log clamped at -100) against the one-hot winners; the velocity
    error and the weighted squared velocity of every hypothesis."""
    w = torch.tensor(reference.JOINT_WEIGHTS, dtype=poses.dtype, device=poses.device)
    err = (w * torch.linalg.vector_norm(poses - target[:, None], dim=-1)).mean(dim=3)
    wta, winner = torch.min(err, dim=1)  # (B, L)
    terms = {"wloss": wta.mean()}
    if train["rmcl_score_reg"] > 0:
        onehot = F.one_hot(winner, poses.shape[1]).permute(0, 2, 1).to(scores.dtype)
        s = scores[..., 0]
        bce = -(onehot * torch.clamp(torch.log(s), min=-100.0)
                + (1 - onehot) * torch.clamp(torch.log1p(-s), min=-100.0))
        terms["score_reg"] = train["rmcl_score_reg"] * bce.mean()
    vel = torch.diff(poses, dim=2)
    if train["vel_loss"] > 0:
        tvel = torch.diff(target, dim=1)[:, None]
        terms["vloss"] = train["vel_loss"] * torch.linalg.vector_norm(vel - tvel, dim=-1).mean()
    if train["smooth_reg"] > 0:
        terms["sreg"] = train["smooth_reg"] * (w[:, None] * vel**2).mean()
    return terms


def train_steps(p: Params, cfg: dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                generators: Sequence[torch.Generator]) -> dict:
    """The reference's steps on ``batches`` from the weights ``p``, one
    data-parallel rank a generator (``reference.follow_steps``): the rMCL
    loss, Adam."""
    t = cfg["train"]

    def loss(params, x, y, draws):
        poses, scores = forward(params, cfg, x, draws)
        return sum(term for term in loss_terms(poses, scores, y, t).values())

    return reference.follow_steps(p, batches, generators, cfg["model"]["drop_path_rate"], loss,
                                  lambda params: reference.Adam(params, t["lr"], t["weight_decay"]))


# ---- yardstick --------------------------------------------------------------

def trunks(cfg: dict) -> List[dict]:
    """Each trunk's width, heads, depth and tokens: the rotations trunk
    over the joints, the segments trunk over the bones."""
    m = cfg["model"]
    joints = len(cfg["skeleton"]["parents"])
    return [
        dict(c=m["channels"], heads=m["nheads"], depth=m["layers"], n=joints),
        dict(c=m["channels_seg"], heads=m["nheads_seg"], depth=m["layers_seg"], n=joints - 1),
    ]


def kernel_ops(cfg: dict, windows: int, backward: bool) -> Dict[Tuple[str, tuple], int]:
    """{(operation, shape): calls} of one forward of ``windows`` windows
    (and its backward): the two trunks' (``yardstick.mixste_kernel_ops``)."""
    return yardstick.mixste_kernel_ops(trunks(cfg), cfg["data"]["seq_len"], windows, backward,
                                       cfg["model"].get("mlp_ratio", 2.0))


def model_flops(cfg: dict, windows: int) -> float:
    """Matrix-product FLOPs of one forward of ``windows`` windows: the
    embeddings, every block's qkv, attention, projection and MLP, the K
    heads and the segments head. Elementwise work is not counted."""
    m, seq_len = cfg["model"], cfg["data"]["seq_len"]
    joints = len(cfg["skeleton"]["parents"])
    total = yardstick.mixste_flops(trunks(cfg), seq_len, windows, m.get("mlp_ratio", 2.0))
    rot_tokens = windows * seq_len * joints
    c, cs = m["channels"], m["channels_seg"]
    n_hyp = cfg["multi_hyp"]["n_hyp"]
    rot_dim = m["rot_dim"]
    total += 2 * rot_tokens * 2 * c  # patch embedding
    total += n_hyp * (2 * rot_tokens * c * (rot_dim + 1) + 2 * windows * seq_len * joints)
    total += 2 * windows * seq_len * (2 * joints) * ((joints - 1) * cs)  # joints -> segments
    total += 2 * windows * seq_len * (joints - 1) * cs  # segments head
    return total
