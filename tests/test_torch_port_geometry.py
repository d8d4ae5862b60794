"""PyTorch port vs the JAX package: skeletons, rotations, forward
kinematics, the pose decoder and the TTA flip, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manipose_tpu import geometry as jgeo
from manipose_tpu.eval.engine import flip_poses as j_flip
from manipose_tpu.models.decoder import decode_poses as j_decode
from manipose_tpu_torch import geometry as tgeo
from manipose_tpu_torch.eval import flip_poses as t_flip
from manipose_tpu_torch.models import decode_poses as t_decode

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j, atol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["h36m_skeleton_16", "h36m_skeleton_17",
                                  "h36m_skeleton_32"])
def test_skeleton_copies_match(name):
    j, t = getattr(jgeo, name)(), getattr(tgeo, name)()
    for field in ("parents", "joints_left", "joints_right", "joints_names",
                  "bones", "levels", "t_pose_operators"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("dim", [4, 6])
def test_rotation_representations(dim):
    rep = _rng(dim).normal(size=(3, 5, 17, dim)).astype(np.float32)
    got = tgeo.rot_to_matrix(torch.from_numpy(rep), dim)
    _close(got, jgeo.rot_to_matrix(jnp.asarray(rep), dim))
    eye = torch.matmul(got.transpose(-1, -2), got)
    torch.testing.assert_close(eye, torch.eye(3).expand_as(eye), atol=1e-5, rtol=0)


def test_normalize_vector_clamp():
    v = np.zeros((2, 3), np.float32)
    v[1] = [3.0, 0.0, 4.0]
    got = tgeo.normalize_vector(torch.from_numpy(v))
    _close(got, jgeo.normalize_vector(jnp.asarray(v)))
    assert torch.equal(got[0], torch.zeros(3))


def test_compose_and_rotate():
    from manipose_tpu.geometry.rotations import compose_rotations, rotate_vectors

    rng = _rng(1)
    a, b = (rng.normal(size=(4, 3, 3)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(4, 3)).astype(np.float32)
    ta, tb, tv = map(torch.from_numpy, (a, b, v))
    _close(tgeo.compose_rotations(ta, tb), compose_rotations(a, b))
    _close(tgeo.rotate_vectors(ta, tv), rotate_vectors(a, v))


def _fk_inputs(seed):
    rng = _rng(seed)
    rots = rng.normal(size=(2, 4, 17, 6)).astype(np.float32)
    lengths = rng.uniform(0.05, 0.5, size=(2, 1, 16)).astype(np.float32)
    roots = rng.normal(size=(2, 4, 3)).astype(np.float32)
    return rots, lengths, roots


def test_forward_kinematics():
    rots, lengths, roots = _fk_inputs(2)
    j_rot = jgeo.rot6d_to_matrix(jnp.asarray(rots))
    t_rot = tgeo.rot6d_to_matrix(torch.from_numpy(rots))
    got = tgeo.forward_kinematics(
        t_rot, torch.from_numpy(lengths), torch.from_numpy(roots),
        tgeo.h36m_skeleton_17(),
    )
    want = jgeo.forward_kinematics(
        j_rot, jnp.asarray(lengths), jnp.asarray(roots), jgeo.h36m_skeleton_17()
    )
    _close(got, want)


def test_forward_kinematics_keeps_bone_lengths():
    """The manifold invariant: FK bone lengths equal the given lengths."""
    rots, lengths, roots = _fk_inputs(3)
    skel = tgeo.h36m_skeleton_17()
    pos = tgeo.forward_kinematics(
        tgeo.rot6d_to_matrix(torch.from_numpy(rots)),
        torch.from_numpy(lengths), torch.from_numpy(roots), skel,
    )
    child = [j for j, _ in skel.bones]
    parent = [p for _, p in skel.bones]
    got = torch.linalg.norm(pos[..., child, :] - pos[..., parent, :], dim=-1)
    torch.testing.assert_close(
        got, torch.from_numpy(lengths).expand_as(got), atol=1e-5, rtol=0
    )
    torch.testing.assert_close(pos[..., 0, :], torch.from_numpy(roots))


def test_build_t_pose():
    lengths = _rng(4).uniform(0.1, 0.4, size=(3, 16)).astype(np.float32)
    got = tgeo.build_t_pose(torch.from_numpy(lengths), tgeo.h36m_skeleton_17())
    _close(got, jgeo.build_t_pose(jnp.asarray(lengths), jgeo.h36m_skeleton_17()))


@pytest.mark.parametrize("dim", [4, 6])
def test_decode_poses(dim):
    rng = _rng(5 + dim)
    rep = rng.normal(size=(2, 3, 5, 17, dim)).astype(np.float32)
    lengths = rng.normal(size=(2, 1, 1, 16)).astype(np.float32)
    roots = np.zeros((2, 3, 5, 3), np.float32)
    got = t_decode(torch.from_numpy(rep), torch.from_numpy(lengths),
                   torch.from_numpy(roots), tgeo.h36m_skeleton_17(), dim)
    want = j_decode(jnp.asarray(rep), jnp.asarray(lengths), jnp.asarray(roots),
                    jgeo.h36m_skeleton_17(), dim)
    _close(got, want)


def test_decode_poses_rejects_wrong_dim():
    with pytest.raises(ValueError):
        t_decode(torch.zeros(1, 17, 4), torch.ones(1, 16), torch.zeros(1, 3),
                 tgeo.h36m_skeleton_17(), 6)


@pytest.mark.parametrize("channels", [2, 3])
def test_flip_poses(channels):
    x = _rng(channels).normal(size=(2, 5, 17, channels)).astype(np.float32)
    got = t_flip(torch.from_numpy(x), tgeo.h36m_skeleton_17())
    _close(got, j_flip(jnp.asarray(x), jgeo.h36m_skeleton_17()), atol=0)
