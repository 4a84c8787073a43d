"""Device-resident model constants (counterpart of agility_tpu/physics/constants.py
plus soa._Consts / consts_of).

`ModelConsts` puts every float table of a `RobotModel` on one device once, in
the working dtype.  `consts_of(mc)` is the SoA layer's view of the same
constants: numpy copies (rounded to the working dtype, so values folded into
the unrolled algebra as Python floats equal the JAX package's) plus the
small per-dof / per-sphere vectors the substep reads as tensors.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference.plain.core.model import RobotModel


def _quat_from_mat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> xyzw quaternion (host, build time)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # pick largest diagonal
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(3)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


@dataclasses.dataclass(frozen=True)
class ModelConsts:
    """Index/structure fields are numpy int32; float fields are tensors on
    `device` in `dtype`."""
    parent: np.ndarray
    joint_pos: torch.Tensor        # (L, 3)
    joint_quat: torch.Tensor       # (L, 4) xyzw
    joint_axis: torch.Tensor       # (L, 3)
    link_mass: torch.Tensor        # (L,)
    link_com: torch.Tensor         # (L, 3)
    link_inertia: torch.Tensor     # (L, 3, 3)
    dof_link: np.ndarray
    dof_limit_lower: torch.Tensor
    dof_limit_upper: torch.Tensor
    dof_effort_limit: torch.Tensor
    dof_velocity_limit: torch.Tensor
    default_dof_pos: torch.Tensor
    body_link: np.ndarray
    body_offset: torch.Tensor      # (B, 3)
    sph_link: np.ndarray
    sph_body: np.ndarray
    sph_offset: torch.Tensor       # (S, 3)
    sph_radius: torch.Tensor       # (S,)
    ancestors: torch.Tensor        # (L, nu) 0/1
    nu: int
    n_links: int
    n_bodies: int

    @property
    def device(self) -> torch.device:
        return self.link_mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.link_mass.dtype

    @staticmethod
    def from_model(m: RobotModel, device="cuda", dtype=torch.float32) -> "ModelConsts":
        sl, sb, so, sr = m.sphere_arrays()
        jq = np.stack([_quat_from_mat_np(R) for R in m.joint_rot])
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
        return ModelConsts(
            parent=np.asarray(m.parent, np.int32), joint_pos=f(m.joint_pos),
            joint_quat=f(jq), joint_axis=f(m.joint_axis), link_mass=f(m.link_mass),
            link_com=f(m.link_com), link_inertia=f(m.link_inertia),
            dof_link=np.asarray(m.dof_link, np.int32),
            dof_limit_lower=f(m.dof_limit_lower), dof_limit_upper=f(m.dof_limit_upper),
            dof_effort_limit=f(m.dof_effort_limit),
            dof_velocity_limit=f(m.dof_velocity_limit),
            default_dof_pos=f(m.default_dof_pos),
            body_link=np.asarray(m.body_link, np.int32), body_offset=f(m.body_offset),
            sph_link=np.asarray(sl, np.int32), sph_body=np.asarray(sb, np.int32),
            sph_offset=f(so), sph_radius=f(sr),
            ancestors=f(m.ancestors.astype(np.float32)),
            nu=m.nu, n_links=m.n_links, n_bodies=m.n_bodies)

    @functools.cached_property
    def soa(self) -> "SoAConsts":
        return SoAConsts(self)


class SoAConsts:
    """Host constants for the env-minor substep (soa._Consts)."""

    def __init__(self, mc: ModelConsts):
        g = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        self.parent = g(mc.parent)
        self.joint_pos = g(mc.joint_pos)
        self.joint_quat = g(mc.joint_quat)
        self.joint_axis = g(mc.joint_axis)
        self.link_mass = g(mc.link_mass)
        self.link_com = g(mc.link_com)
        self.link_inertia = g(mc.link_inertia)
        self.dof_link = g(mc.dof_link)
        self.body_link = g(mc.body_link)
        self.body_offset = g(mc.body_offset)
        self.sph_link = g(mc.sph_link)
        self.sph_body = g(mc.sph_body)
        self.sph_offset = g(mc.sph_offset)
        self.ancestors = g(mc.ancestors)
        self.nu = mc.nu
        self.L = mc.n_links
        self.nb = mc.n_bodies
        self.S = len(self.sph_link)
        # device vectors read by the substep, (k, 1) for env-minor broadcast
        col = lambda t: t[:, None]
        self.lower = col(mc.dof_limit_lower)
        self.upper = col(mc.dof_limit_upper)
        self.effort = col(mc.dof_effort_limit)
        self.vel_limit = col(mc.dof_velocity_limit)
        self.sph_radius = col(mc.sph_radius)
        # (nb, S) 0/1 sphere -> body accumulation matrix
        m = torch.zeros((self.nb, self.S), dtype=mc.dtype)
        m[self.sph_body, torch.arange(self.S)] = 1.0
        self.body_mat = m.to(mc.device)
        # spheres on the base link (trunk + head), tested against ceiling
        # surfaces (tunnel roof, tire top ring); they lead the sphere list
        cs = np.nonzero(self.sph_link == 0)[0]
        if not (cs == np.arange(len(cs))).all():
            raise ValueError("the base-link spheres must lead the sphere list")
        self.n_ceil = len(cs)
        # (S, nu) sphere-lever masks (ancestors of each sphere's link)
        self.lever_mask = torch.as_tensor(self.ancestors[self.sph_link],
                                          dtype=mc.dtype, device=mc.device)
        # legs: dof chains hanging off the base (3 dofs each for Go2)
        legs = []
        for l in range(1, self.L):
            if self.parent[l] == 0:
                chain, child = [l - 1], l
                while True:
                    nxt = [k for k in range(1, self.L) if self.parent[k] == child]
                    if not nxt:
                        break
                    child = nxt[0]
                    chain.append(child - 1)
                legs.append(chain)
        self.legs = legs


def consts_of(mc: ModelConsts) -> SoAConsts:
    return mc.soa
