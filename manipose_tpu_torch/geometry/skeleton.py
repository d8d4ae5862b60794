"""Kinematic-tree skeleton metadata (static, hashable).

The port's own copy of ``manipose_tpu/geometry/skeleton.py``: importing
that module would run ``manipose_tpu/geometry/__init__.py``, which
imports JAX.

Redesign of the reference's mutable ``Skeleton`` class
(``hpe/mh_so3_hpe/data/skeleton.py:7-172``): all metadata is precomputed
into immutable tuples, and the kinematic tree is additionally
grouped into *levels* (joints at equal tree depth) so forward kinematics
can run level-parallel instead of joint-sequential
(cf. ``hpe/mh_so3_hpe/architectures/utils/forward_kinematics.py:25-47``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Immutable kinematic tree.

    Parameters mirror the reference constructor
    (``data/skeleton.py:8-32``); derived metadata mirrors
    ``_compute_metadata`` (``data/skeleton.py:87-120``).

    ``t_pose_operators[j]`` is the unit translation direction from joint
    ``j``'s parent to joint ``j`` in the canonical T-pose (row 0 — the
    root — is all-zero). Reference: ``data/h36m_lifting.py:40-57``.
    """

    parents: Tuple[int, ...]
    joints_left: Tuple[int, ...]
    joints_right: Tuple[int, ...]
    t_pose_operators: Optional[Tuple[Vec3, ...]] = None
    joints_names: Optional[Tuple[str, ...]] = None

    # ---- derived (filled in __post_init__) ----
    bones: Tuple[Tuple[int, int], ...] = dataclasses.field(init=False)
    bones_names: Tuple[str, ...] = dataclasses.field(init=False)
    bones_left: Tuple[int, ...] = dataclasses.field(init=False)
    bones_right: Tuple[int, ...] = dataclasses.field(init=False)
    levels: Tuple[Tuple[int, ...], ...] = dataclasses.field(init=False)

    def __post_init__(self):
        parents = np.asarray(self.parents)
        n = len(parents)
        names = self.joints_names
        if names is None:
            names = tuple([""] * n)
            object.__setattr__(self, "joints_names", names)
        if len(names) != n:
            raise ValueError("need one name per joint")
        if len(self.joints_left) != len(self.joints_right):
            raise ValueError("joints_left and joints_right differ in length")

        # Bones as (joint, parent) pairs, ordered by child joint index
        # (reference ``data/skeleton.py:100-103``).
        bones = tuple((j, int(p)) for j, p in enumerate(parents) if p >= 0)
        object.__setattr__(self, "bones", bones)
        object.__setattr__(
            self, "bones_names", tuple(f"{names[p]}->{names[j]}" for j, p in bones)
        )

        # Left/right bone index lists, in joints_left/right order
        # (reference ``data/skeleton.py:110-120``).
        bone_index = {b: i for i, b in enumerate(bones)}
        bone_parent = dict(bones)
        for side in ("left", "right"):
            joints = getattr(self, f"joints_{side}")
            object.__setattr__(self, f"bones_{side}", tuple(
                bone_index[(j, bone_parent[j])] for j in joints if j >= 0))

        # Tree levels: level 0 = roots; level k = joints at depth k.
        depth = np.full(n, -1, dtype=int)
        for j in range(n):
            d, cur = 0, j
            while parents[cur] != -1:
                cur = parents[cur]
                d += 1
                if d > n:
                    raise ValueError("cycle in skeleton parents")
            depth[j] = d
        levels = tuple(
            tuple(int(j) for j in np.nonzero(depth == d)[0])
            for d in range(int(depth.max()) + 1)
        )
        object.__setattr__(self, "levels", levels)

    # ------------------------------------------------------------------
    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_bones(self) -> int:
        return len(self.bones)

    def t_pose_array(self) -> np.ndarray:
        """(J, 3) float32 array of T-pose unit offsets; row 0 is zero."""
        if self.t_pose_operators is None:
            raise ValueError("skeleton has no T-pose operators")
        return np.asarray(self.t_pose_operators, dtype=np.float32)

    # ------------------------------------------------------------------
    def remove_joints(self, joints_to_remove: Sequence[int]) -> "Skeleton":
        """Return a new skeleton with ``joints_to_remove`` dropped and
        parents rewired through the removed joints.

        Functional counterpart of the reference's in-place
        ``Skeleton.remove_joints`` (``data/skeleton.py:34-85``).
        ``t_pose_operators`` are NOT carried over (the reference attaches
        operators designed for the reduced skeleton, see
        ``data/h36m_lifting.py:40-57``): attach them explicitly after
        reduction via :meth:`replace`.
        """
        remove = set(int(j) for j in joints_to_remove)
        parents = list(self.parents)
        n = len(parents)

        # Rewire parents through removed joints.
        for i in range(n):
            while parents[i] in remove:
                parents[i] = parents[parents[i]] if parents[i] != -1 else -1

        keep = [i for i in range(n) if i not in remove]
        new_index = {old: new for new, old in enumerate(keep)}
        new_parents = tuple(
            new_index[parents[old]] if parents[old] != -1 else -1 for old in keep
        )
        left = set(self.joints_left)
        right = set(self.joints_right)
        new_left = tuple(new_index[j] for j in keep if j in left)
        new_right = tuple(new_index[j] for j in keep if j in right)
        new_names = tuple(self.joints_names[j] for j in keep)
        return Skeleton(
            parents=new_parents,
            joints_left=new_left,
            joints_right=new_right,
            t_pose_operators=None,
            joints_names=new_names,
        )

    def replace(self, **kwargs) -> "Skeleton":
        fields = dict(
            parents=self.parents,
            joints_left=self.joints_left,
            joints_right=self.joints_right,
            t_pose_operators=self.t_pose_operators,
            joints_names=self.joints_names,
        )
        fields.update(kwargs)
        return Skeleton(**fields)

    def with_parent_rewired(self, joint: int, new_parent: int) -> "Skeleton":
        parents = list(self.parents)
        parents[joint] = new_parent
        return self.replace(parents=tuple(parents))
