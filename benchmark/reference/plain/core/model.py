"""Static robot model description (numpy; counterpart of agility_tpu/core/model.py).

A `RobotModel` is a plain container of numpy constants describing a floating-
base kinematic tree, built once on the host.  Conventions:
  * link 0 is the floating base; links are in depth-first URDF order.
  * generalized velocity u: [base lin vel world (3), base ang vel world (3),
    joint qd (nu)]  ->  nv = 6 + nu
  * "bodies" are the reported rigid-body frames (17 for Go2: the 13 moving
    links plus the 4 fixed foot frames).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class CollisionSphere:
    """A collision sphere on a moving link; `body` is the reported body that
    receives its contact force."""
    link: int
    body: int
    offset: np.ndarray  # (3,) in link frame
    radius: float
    name: str = ""


@dataclasses.dataclass
class RobotModel:
    link_names: List[str]                 # (L,)
    parent: np.ndarray                    # (L,) int, -1 for base
    joint_pos: np.ndarray                 # (L, 3) joint origin in parent frame
    joint_rot: np.ndarray                 # (L, 3, 3) parent->child rotation at q=0
    joint_axis: np.ndarray                # (L, 3) revolute axis in child frame
    link_mass: np.ndarray                 # (L,)
    link_com: np.ndarray                  # (L, 3) in link frame
    link_inertia: np.ndarray              # (L, 3, 3) about link COM, link frame
    dof_names: List[str]                  # (nu,)
    dof_link: np.ndarray                  # (nu,) moving-link index of each dof
    dof_limit_lower: np.ndarray
    dof_limit_upper: np.ndarray
    dof_effort_limit: np.ndarray
    dof_velocity_limit: np.ndarray
    default_dof_pos: np.ndarray
    body_names: List[str]                 # (B,)
    body_link: np.ndarray                 # (B,) moving link carrying the body
    body_offset: np.ndarray               # (B, 3) fixed offset in link frame
    spheres: List[CollisionSphere]
    ancestors: np.ndarray                 # (L, nu) bool: dof j on path base->link l

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    @property
    def nu(self) -> int:
        return len(self.dof_names)

    @property
    def n_bodies(self) -> int:
        return len(self.body_names)

    def sphere_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        link = np.array([s.link for s in self.spheres], np.int32)
        body = np.array([s.body for s in self.spheres], np.int32)
        offset = np.stack([s.offset for s in self.spheres]).astype(np.float64)
        radius = np.array([s.radius for s in self.spheres], np.float64)
        return link, body, offset, radius

    def match_bodies(self, substr: str) -> List[int]:
        """Reported-body indices whose name contains `substr`."""
        return [i for i, n in enumerate(self.body_names) if substr in n]


def merge_inertia(m1, com1, I1, m2, com2, I2):
    """Combine two bodies in a common frame into one composite
    (mass, COM, inertia about the composite COM)."""
    m = m1 + m2
    if m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = (m1 * com1 + m2 * com2) / m

    def shift(I, mi, ci):
        d = ci - com
        return I + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, com, shift(I1, m1, com1) + shift(I2, m2, com2)


def rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis rpy -> rotation matrix (R = Rz(y) @ Ry(p) @ Rx(r))."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
