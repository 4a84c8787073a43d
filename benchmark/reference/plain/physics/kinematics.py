"""Forward kinematics, velocities and Jacobians of a batch of envs
(counterpart of agility_tpu/physics/kinematics.py).

The JAX functions are written for one env and vmapped by the engine; here
every tensor has a leading env axis N and the same functions run on the
whole batch.  The 13-link tree loop is unrolled in Python, as in JAX.  The
model constants may carry the per-env payload and CoM shift
(engine._env_consts): `link_mass` (L,) or (N, L), `link_com` (L, 3) or
(N, L, 3); every other field is shared by all envs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.plain.core import quat as qm
from benchmark.reference.plain.physics.constants import ModelConsts


class LinkState(NamedTuple):
    pos: torch.Tensor    # (N, L, 3) link frame origin, world
    quat: torch.Tensor   # (N, L, 4) link frame orientation, world, xyzw
    com: torch.Tensor    # (N, L, 3) link COM, world
    # populated by `velocities`:
    omega: torch.Tensor  # (N, L, 3) angular velocity, world
    vel: torch.Tensor    # (N, L, 3) linear velocity of the link frame origin, world
    vcom: torch.Tensor   # (N, L, 3) linear velocity of the COM, world


def ix(idx, device) -> torch.Tensor:
    """A numpy index array (int32 in ModelConsts) as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def fk(mc: ModelConsts, base_pos, base_quat, qj) -> LinkState:
    """Positions and orientations of all links; base_pos (N, 3), base_quat
    (N, 4), qj (N, nu).  The velocity fields are zeros."""
    L = mc.n_links
    pos, quat = [base_pos] + [None] * (L - 1), [base_quat] + [None] * (L - 1)
    # link l > 0 is driven by dof l - 1 (dof order == link order minus the base)
    for l in range(1, L):
        p = int(mc.parent[l])
        jq = qm.quat_from_axis_angle(mc.joint_axis[l], qj[:, l - 1])
        quat[l] = qm.quat_mul(quat[p], qm.quat_mul(mc.joint_quat[l], jq))
        pos[l] = pos[p] + qm.quat_rotate(quat[p], mc.joint_pos[l])
    pos, quat = torch.stack(pos, dim=1), torch.stack(quat, dim=1)
    com = pos + qm.quat_rotate(quat, mc.link_com)
    z = torch.zeros_like(pos)
    return LinkState(pos, quat, com, z, z, z)


def velocities(mc: ModelConsts, ls: LinkState, base_lin, base_ang, qdj) -> LinkState:
    """World-frame velocities propagated down the tree."""
    L = mc.n_links
    omega, vel = [base_ang] + [None] * (L - 1), [base_lin] + [None] * (L - 1)
    for l in range(1, L):
        p = int(mc.parent[l])
        axis_w = qm.quat_rotate(ls.quat[:, l], mc.joint_axis[l])
        omega[l] = omega[p] + axis_w * qdj[:, l - 1, None]
        vel[l] = vel[p] + _cross(omega[p], ls.pos[:, l] - ls.pos[:, p])
    omega, vel = torch.stack(omega, dim=1), torch.stack(vel, dim=1)
    vcom = vel + _cross(omega, ls.com - ls.pos)
    return ls._replace(omega=omega, vel=vel, vcom=vcom)


def world_axes(mc: ModelConsts, ls: LinkState) -> torch.Tensor:
    """(N, nu, 3) world-frame joint axes."""
    dl = ix(mc.dof_link, ls.pos.device)
    return qm.quat_rotate(ls.quat[:, dl], mc.joint_axis[dl])


def _base_block(r):
    """(..., 3, 6) linear-velocity Jacobian of points at moment arms r from
    the base origin with respect to the base twist: [I, -[r]x]."""
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(r.shape[:-1] + (3, 3))
    return torch.cat([eye, -qm.skew(r)], dim=-1)


def _levers(mc: ModelConsts, ls: LinkState, axes_w, mask, points_w):
    """(N, P, 3, nu) joint columns of the points' linear-velocity Jacobians:
    mask (P, nu) * axis_d x (point - joint origin d)."""
    jp = ls.pos[:, ix(mc.dof_link, ls.pos.device)]                  # (N, nu, 3)
    lever = _cross(axes_w[:, None], points_w[:, :, None] - jp[:, None])  # (N, P, nu, 3)
    return (mask[..., None] * lever).transpose(-1, -2)


def point_jacobian(mc: ModelConsts, ls: LinkState, axes_w, link_idx: int, point_w):
    """Jv, Jw (N, 3, nv) of world points point_w (N, 3) rigidly attached to
    link `link_idx`; generalized velocity u = [v_base, w_base, qd]."""
    N = point_w.shape[0]
    z = torch.zeros((N, 3, 3), dtype=point_w.dtype, device=point_w.device)
    eye = torch.eye(3, dtype=point_w.dtype, device=point_w.device).expand(N, 3, 3)
    mask = mc.ancestors[link_idx][None]                               # (1, nu)
    Jv = torch.cat([_base_block(point_w - ls.pos[:, 0]),
                    _levers(mc, ls, axes_w, mask, point_w[:, None])[:, 0]], dim=-1)
    Jw = torch.cat([z, eye, (mask[..., None] * axes_w).transpose(-1, -2)], dim=-1)
    return Jv, Jw


def com_jacobians(mc: ModelConsts, ls: LinkState, axes_w):
    """COM Jacobians of all links: Jv, Jw (N, L, 3, nv)."""
    N, L = ls.pos.shape[:2]
    Jv = points_jacobian(mc, ls, axes_w, np.arange(L), ls.com)
    z = torch.zeros((N, L, 3, 3), dtype=ls.pos.dtype, device=ls.pos.device)
    eye = torch.eye(3, dtype=ls.pos.dtype, device=ls.pos.device).expand(N, L, 3, 3)
    Jw_j = (mc.ancestors[:, :, None] * axes_w[:, None]).transpose(-1, -2)   # (N, L, 3, nu)
    return Jv, torch.cat([z, eye, Jw_j], dim=-1)


def points_jacobian(mc: ModelConsts, ls: LinkState, axes_w, link_idx, points_w):
    """Linear-velocity Jacobians (N, P, 3, nv) of world points points_w
    (N, P, 3) rigidly attached to links link_idx (P,) (numpy)."""
    mask = mc.ancestors[ix(link_idx, points_w.device)]               # (P, nu)
    return torch.cat([_base_block(points_w - ls.pos[:, :1]),
                      _levers(mc, ls, axes_w, mask, points_w)], dim=-1)


def body_states(mc: ModelConsts, ls: LinkState):
    """Reported rigid-body states pos (N, B, 3), quat (N, B, 4), vel (N, B, 3),
    omega (N, B, 3): the layout of the reference's rigid_body_state tensor."""
    bl = ix(mc.body_link, ls.pos.device)
    off_w = qm.quat_rotate(ls.quat[:, bl], mc.body_offset)
    omega = ls.omega[:, bl]
    return ls.pos[:, bl] + off_w, ls.quat[:, bl], ls.vel[:, bl] + _cross(omega, off_w), omega


def sphere_centers(mc: ModelConsts, ls: LinkState):
    """World centres (N, S, 3) and velocities (N, S, 3) of the collision spheres."""
    sl = ix(mc.sph_link, ls.pos.device)
    off_w = qm.quat_rotate(ls.quat[:, sl], mc.sph_offset)
    return ls.pos[:, sl] + off_w, ls.vel[:, sl] + _cross(ls.omega[:, sl], off_w)
