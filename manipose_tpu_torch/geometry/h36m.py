"""Human3.6M skeleton definitions (32 / 17 / 16 joint variants).

Constants re-derived from the reference dataset module
(``hpe/mh_so3_hpe/data/h36m_lifting.py:15-121,631-660``): the raw mocap
skeleton has 32 joints; the working skeletons keep the 17 (VideoPose3D
subset) or 16 moving joints with shoulders re-parented to the thorax.
"""

from __future__ import annotations

from .skeleton import Skeleton

H36M_NAMES_32 = [""] * 32
for _i, _n in {
    0: "Hip", 1: "RHip", 2: "RKnee", 3: "RFoot", 6: "LHip", 7: "LKnee",
    8: "LFoot", 12: "Spine", 13: "Thorax", 14: "Neck/Nose", 15: "Head",
    17: "LShoulder", 18: "LElbow", 19: "LWrist", 25: "RShoulder",
    26: "RElbow", 27: "RWrist",
}.items():
    H36M_NAMES_32[_i] = _n
H36M_NAMES_32 = tuple(H36M_NAMES_32)

TRAIN_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")
TEST_SUBJECTS = ("S9", "S11")

# Unit translation from parent to joint in the canonical T-pose, keyed by
# *reduced* joint index 1..16 (``h36m_lifting.py:40-57``). Joint 0 (root)
# gets the zero vector.
_T_POSE_OPERATORS_REDUCED = (
    (0.0, 0.0, 0.0),   # 0 root
    (1.0, 0.0, 0.0),   # 1
    (0.0, -1.0, 0.0),  # 2
    (0.0, -1.0, 0.0),  # 3
    (-1.0, 0.0, 0.0),  # 4
    (0.0, -1.0, 0.0),  # 5
    (0.0, -1.0, 0.0),  # 6
    (0.0, 1.0, 0.0),   # 7
    (0.0, 1.0, 0.0),   # 8
    (0.0, 1.0, 0.0),   # 9
    (0.0, 1.0, 0.0),   # 10
    (-1.0, 0.0, 0.0),  # 11
    (-1.0, 0.0, 0.0),  # 12
    (-1.0, 0.0, 0.0),  # 13
    (1.0, 0.0, 0.0),   # 14
    (1.0, 0.0, 0.0),   # 15
    (1.0, 0.0, 0.0),   # 16
)

# Joints removed to obtain the 17-joint VideoPose3D subset
# (``h36m_lifting.py:652-654``).
REMOVED_JOINTS_17 = (4, 5, 9, 10, 11, 16, 20, 21, 22, 23, 24, 28, 29, 30, 31)


def h36m_skeleton_32() -> Skeleton:
    """Full 32-joint H36M mocap skeleton (``h36m_lifting.py:60-99``)."""
    return Skeleton(
        parents=(
            -1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 0, 11, 12, 13, 14, 12, 16, 17,
            18, 19, 20, 19, 22, 12, 24, 25, 26, 27, 28, 27, 30,
        ),
        joints_left=(6, 7, 8, 9, 10, 16, 17, 18, 19, 20, 21, 22, 23),
        joints_right=(1, 2, 3, 4, 5, 24, 25, 26, 27, 28, 29, 30, 31),
        joints_names=H36M_NAMES_32,
    )


def h36m_skeleton_17() -> Skeleton:
    """17-joint working skeleton with shoulders re-parented to the thorax
    (``h36m_lifting.py:649-660``) and T-pose operators attached."""
    skel = h36m_skeleton_32().remove_joints(REMOVED_JOINTS_17)
    skel = skel.with_parent_rewired(11, 8).with_parent_rewired(14, 8)
    return skel.replace(t_pose_operators=_T_POSE_OPERATORS_REDUCED)


def h36m_skeleton_16() -> Skeleton:
    """16-joint variant: additionally drops 'Neck/Nose'
    (``h36m_lifting.py:632-648``).

    T-pose operators are RE-INDEXED for the removed joint: joints after
    the dropped Neck/Nose (17-joint index 9) shift down by one. The
    reference reuses its 17-joint-keyed dict unchanged
    (``h36m_lifting.py:40-57``), silently giving the 16-joint LShoulder
    the Head's (0,1,0) direction — a latent defect this build fixes.
    """
    base = h36m_skeleton_32()
    remove = tuple(
        i for i, name in enumerate(H36M_NAMES_32) if name in ("", "Neck/Nose")
    )
    skel = base.remove_joints(remove)
    skel = skel.with_parent_rewired(10, 8).with_parent_rewired(13, 8)
    ops16 = tuple(
        _T_POSE_OPERATORS_REDUCED[j if j < 9 else j + 1]
        for j in range(skel.num_joints)
    )
    return skel.replace(t_pose_operators=ops16)
