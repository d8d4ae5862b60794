"""The port's H36M data path against the JAX package, on the CPU: the
quaternion and camera functions, the rig calibration, the dataset
(``Human36mDataset``, ``read_3d_data``, ``create_2d_data``, ``fetch``), the
windowing (``PoseSequenceDataset.get_batch``, ``SequenceLoader``) and the
native windowing core against its numpy branch.

All of it is host-side numpy on both sides, so every comparison is bit for
bit (``assert_array_equal``): the port copies the JAX package's arithmetic
and draws from the numpy generator call for call. Inputs are made with
numpy from a seed; the H36M npz pair is written the way
``tests/test_driver_h36m.py`` writes it."""

import numpy as np
import pytest
import torch

import manipose_tpu.data as jd
from manipose_tpu.data import h36m_cameras as j_cams
from manipose_tpu.data.pipeline import SequenceLoader as JLoader
from manipose_tpu.data.windowing import PoseSequenceDataset as JDataset
from manipose_tpu.geometry import h36m_skeleton_17 as j_skeleton
import manipose_tpu_torch.data as td
from manipose_tpu_torch.data import h36m_cameras as t_cams
from manipose_tpu_torch.data import native
from manipose_tpu_torch.data.pipeline import Batch, prefetch
from manipose_tpu_torch.geometry import h36m_skeleton_17 as t_skeleton

SUBJECTS = ("S1", "S9", "S11")
ACTIONS = ("Walking", "Eating", "Walking 1")
FRAMES = {"Walking": 40, "Eating": 31, "Walking 1": 9}


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    """A seeded npz pair in the H36M layout: 32-joint world positions and,
    per camera, 2D detections in pixels."""
    data_dir = tmp_path_factory.mktemp("h36m")
    rng = np.random.default_rng(0)
    positions_3d = {
        s: {a: rng.normal(scale=0.3, size=(FRAMES[a], 32, 3)).astype(np.float32)
            for a in ACTIONS}
        for s in SUBJECTS
    }
    np.savez(data_dir / "data_3d_h36m.npz", positions_3d=positions_3d)
    positions_2d = {
        s: {a: [rng.uniform(0, 1000, size=(FRAMES[a], 17, 2)).astype(np.float32)
                for _ in range(4)]
            for a in ACTIONS}
        for s in SUBJECTS
    }
    np.savez(data_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", positions_2d=positions_2d)
    return data_dir


def _equal_nested(got, want):
    """Bit-equal nested dicts / lists / tuples of arrays and scalars."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal_nested(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_nested(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---- quaternions and cameras ----------------------------------------------

def test_quaternion_and_camera_functions_are_bit_exact():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(5, 7, 3)).astype(np.float32)
    for name in ("qrot",):
        np.testing.assert_array_equal(getattr(td, name)(q, v), getattr(jd, name)(q, v))
    np.testing.assert_array_equal(td.qinverse(q), jd.qinverse(q))

    x2 = rng.uniform(0, 1000, size=(6, 17, 2)).astype(np.float32)
    for name in ("normalize_screen_coordinates", "image_coordinates"):
        np.testing.assert_array_equal(getattr(td, name)(x2, 1000, 1002),
                                      getattr(jd, name)(x2, 1000, 1002))
    pts = rng.normal(size=(6, 17, 3)).astype(np.float32)
    r, t = q[0, 0], rng.normal(size=3).astype(np.float32)
    for name in ("world_to_camera", "camera_to_world"):
        np.testing.assert_array_equal(getattr(td, name)(pts, r, t),
                                      getattr(jd, name)(pts, r, t))
    cam_pts = pts + np.asarray([0, 0, 5], np.float32)
    intrinsic = rng.normal(scale=0.1, size=(6, 9)).astype(np.float32)
    for name in ("project_to_2d", "project_to_2d_linear"):
        np.testing.assert_array_equal(getattr(td, name)(cam_pts, intrinsic),
                                      getattr(jd, name)(cam_pts, intrinsic))
    uvd = rng.normal(size=(2, 4, 17, 3)).astype(np.float32)
    f = rng.uniform(1, 2, size=(2, 4)).astype(np.float32)
    c = rng.normal(size=(2, 4, 2)).astype(np.float32)
    dist = rng.uniform(4, 6, size=(2, 4)).astype(np.float32)
    np.testing.assert_array_equal(td.uvd2xyz(uvd, f, c, dist), jd.uvd2xyz(uvd, f, c, dist))
    cam = rng.normal(size=(2, 4, 16)).astype(np.float32)
    cam[..., 0] = f
    np.testing.assert_array_equal(td.uvd2xyz_from_cam(uvd, cam),
                                  jd.uvd2xyz_from_cam(uvd, cam))


def test_rig_calibration_is_the_same_data():
    _equal_nested(t_cams.build_cameras(), j_cams.build_cameras())


# ---- dataset -------------------------------------------------------------

@pytest.mark.parametrize("n_joints", [17, 16])
def test_dataset_read_and_fetch_are_bit_exact(h36m_dir, n_joints):
    """Human36mDataset, read_3d_data (world -> per-camera root-relative),
    create_2d_data (screen-normalized per camera) and fetch, with an action
    filter and a stride."""
    data = {}
    for side, mod in (("jax", jd), ("port", td)):
        ds = mod.Human36mDataset(h36m_dir / "data_3d_h36m.npz", n_joints=n_joints)
        assert ds.skeleton.bones_names and ds.skeleton.bones_left
        ds = mod.read_3d_data(ds, subjects_filter=["S9", "S11"])
        kps = mod.create_2d_data(h36m_dir / "data_2d_h36m_cpn_ft_h36m_dbb.npz", ds)
        fetched = [mod.fetch(["S9", "S11"], ds, kps, action_filter=["walking"]),
                   mod.fetch(["S11"], ds, kps, stride=2)]
        data[side] = (ds, kps, fetched)
    (j_ds, j_kps, j_fetch), (t_ds, t_kps, t_fetch) = data["jax"], data["port"]
    assert list(t_ds.subjects) == list(j_ds.subjects)
    for s in j_ds.subjects:
        _equal_nested({a: {k: v for k, v in d.items() if k != "cameras"}
                       for a, d in t_ds[s].items()},
                      {a: {k: v for k, v in d.items() if k != "cameras"}
                       for a, d in j_ds[s].items()})
    _equal_nested(t_ds.cameras, j_ds.cameras)
    _equal_nested(t_kps, j_kps)
    _equal_nested(t_fetch, j_fetch)
    assert t_ds.skeleton.bones_names == j_ds.skeleton.bones_names
    assert t_ds.define_actions("eating") == j_ds.define_actions("eating")


# ---- windowing -------------------------------------------------------------

def _videos(seed=2, lengths=(40, 27, 9, 100)):
    rng = np.random.default_rng(seed)
    p3 = [rng.normal(size=(n, 17, 3)).astype(np.float32) for n in lengths]
    p2 = [rng.normal(size=(n, 17, 2)).astype(np.float32) for n in lengths]
    return p3, p2


CASES = [
    dict(random_start=False, miss_type="no_miss"),
    dict(random_start=True, miss_type="no_miss"),
    dict(random_start=True, miss_type="all", flip_probability=0.5),
    dict(random_start=False, miss_type="random", miss_rate=0.3),
    dict(random_start=True, miss_type="noisy", flip_probability=0.5),
    dict(random_start=False, miss_type="structured_frame", drop_last=False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_windows_and_loader_batches_are_bit_exact(case):
    """get_batch and SequenceLoader batches under one seed: sequential and
    random starts, replicate padding, flips and every miss pattern, and
    the padded last batch's valid mask."""
    p3, p2 = _videos()
    kw = dict(seq_len=9, skeleton=None, **case)
    j_ds = JDataset(p3, p2, **{**kw, "skeleton": j_skeleton()})
    t_ds = td.PoseSequenceDataset(p3, p2, **{**kw, "skeleton": t_skeleton()})
    assert len(t_ds) == len(j_ds)
    idx = np.arange(len(j_ds))[::-1]
    _equal_nested(t_ds.get_batch(idx, np.random.default_rng(5)),
                  j_ds.get_batch(idx, np.random.default_rng(5)))
    for shuffle in (False, True):
        j_loader = JLoader(j_ds, batch_size=4, shuffle=shuffle, seed=3)
        t_loader = td.SequenceLoader(t_ds, batch_size=4, shuffle=shuffle, seed=3)
        assert len(t_loader) == len(j_loader)
        for epoch in range(2):  # the second epoch draws its own stream
            got, want = list(t_loader), list(j_loader)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _equal_nested((g.pose_2d, g.pose_3d, g.valid),
                              (w.pose_2d, w.pose_3d, w.valid))
    assert want[-1].valid.min() == (0.0 if len(j_ds) % 4 else 1.0)


def test_pose_flip_and_miss_masks_are_bit_exact():
    p3, p2 = _videos(lengths=(12,))
    _equal_nested(td.pose_flip((p2[0], p3[0]), t_skeleton()),
                  jd.pose_flip((p2[0], p3[0]), j_skeleton()))
    for miss_type in ("no_miss", "random", "random_left_arm_right_leg",
                      "structured_joint", "structured_frame"):
        _equal_nested(td.make_miss_mask(np.random.default_rng(1), 30, 17, miss_type, 0.2),
                      jd.make_miss_mask(np.random.default_rng(1), 30, 17, miss_type, 0.2))


def test_native_core_matches_its_numpy_branch():
    """The port's ctypes binding of native/windowing.cpp (built into
    build/native/) against its numpy branch: windows past a video's end
    are replicate-padded, masks multiply in place."""
    assert native.load_library() is not None
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"
    p3, _ = _videos(lengths=(40, 5, 17))
    vid = np.asarray([0, 1, 2, 0, 2, 1, 0, 0])
    start = np.asarray([0, 0, 10, 35, 0, 3, 31, 20])
    got = native.gather_windows(p3, vid, start, 9)
    np.testing.assert_array_equal(got, native.gather_windows_plain(p3, vid, start, 9))
    masks = (np.random.default_rng(0).uniform(size=got.shape[:3]) > 0.3).astype(np.float32)
    want = native.apply_masks_plain(got.copy(), masks)
    np.testing.assert_array_equal(native.apply_masks(got, masks), want)
    with pytest.raises(ValueError):
        native.gather_windows([p3[0], p3[0][..., :2]], vid[:2], start[:2], 9)


def test_batches_go_to_the_device_and_prefetch_stops():
    """Batch.to_device on the CPU keeps the arrays' values; prefetch hands
    a producer's exception to the consumer and stops its thread when the
    consumer stops early."""
    b = Batch(np.ones((2, 3, 17, 2), np.float32), np.zeros((2, 3, 17, 3), np.float32),
              np.asarray([1, 0], np.float32))
    x, y, v = b.to_device(torch.device("cpu"))
    assert x.shape == (2, 3, 17, 2) and float(v.sum()) == 1.0

    def boom():
        yield 1
        raise KeyError("producer failed")

    with pytest.raises(KeyError):
        list(prefetch(boom()))
    gen = prefetch(iter(range(1000)), size=1)
    assert next(gen) == 0
    gen.close()
