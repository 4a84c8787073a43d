"""Articulated rigid-body dynamics of a batch of envs (counterpart of
agility_tpu/physics/dynamics.py).

Projected Newton-Euler in world coordinates with generalized velocity
u = [v_base_w, w_base_w, qd]:

  M(q)   = sum_l m_l Jv_l^T Jv_l + Jw_l^T I_l^w Jw_l
  C(q,u) = sum_l Jv_l^T m_l a_com_l|u'=0 + Jw_l^T (I_l^w alpha_l|u'=0 + w_l x I_l^w w_l)
  M u'   = tau - C        (gravity folded into C as a -g base acceleration)

M factors by the quadruped's branch structure: four 3 x 3 leg blocks and a
6 x 6 base Schur complement, inverted in closed form.  Every tensor has a
leading env axis N; `link_mass` may be (N, L) (the per-env payload).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.core import quat as qm
from benchmark.reference.plain.physics.constants import ModelConsts
from benchmark.reference.plain.physics.kinematics import LinkState, _cross, com_jacobians


def world_inertia(mc: ModelConsts, ls: LinkState) -> torch.Tensor:
    """(N, L, 3, 3) link rotational inertia about the COM, world frame."""
    R = qm.quat_to_rotmat(ls.quat)
    return R @ mc.link_inertia @ R.transpose(-1, -2)


def _masses(mc: ModelConsts, ls: LinkState) -> torch.Tensor:
    """(N, L) link masses (the base's carries the env's payload)."""
    return torch.broadcast_to(mc.link_mass, ls.pos.shape[:2])


def mass_matrix(mc: ModelConsts, ls: LinkState, axes_w) -> torch.Tensor:
    """(N, nv, nv) joint-space inertia matrix."""
    Jv, Jw = com_jacobians(mc, ls, axes_w)
    Iw = world_inertia(mc, ls)
    M = torch.einsum("nl,nlai,nlaj->nij", _masses(mc, ls), Jv, Jv)
    return M + torch.einsum("nlai,nlab,nlbj->nij", Jw, Iw, Jw)


def inertial_forces(mc: ModelConsts, ls: LinkState, axes_w, qdj, gravity):
    """Per-link inertial force f (N, L, 3) and torque n (N, L, 3) at u' = 0
    with a fictitious base acceleration of -gravity (the RNEA gravity trick),
    and the world inertias (N, L, 3, 3).  gravity: a 3-tuple or tensor."""
    L = mc.n_links
    g = torch.as_tensor(gravity, dtype=ls.pos.dtype, device=ls.pos.device)
    alpha = [torch.zeros_like(ls.pos[:, 0])] + [None] * (L - 1)
    a_frame = [(-g).expand_as(ls.pos[:, 0])] + [None] * (L - 1)
    for l in range(1, L):
        p = int(mc.parent[l])
        r = ls.pos[:, l] - ls.pos[:, p]
        w = ls.omega[:, p]
        a_frame[l] = a_frame[p] + _cross(alpha[p], r) + _cross(w, _cross(w, r))
        # d/dt(axis_w * qd) with qdd = 0: (w_p x axis_w) qd
        alpha[l] = alpha[p] + _cross(w, axes_w[:, l - 1]) * qdj[:, l - 1, None]
    alpha, a_frame = torch.stack(alpha, dim=1), torch.stack(a_frame, dim=1)
    c = ls.com - ls.pos
    a_com = a_frame + _cross(alpha, c) + _cross(ls.omega, _cross(ls.omega, c))
    Iw = world_inertia(mc, ls)
    f = _masses(mc, ls)[..., None] * a_com
    n = (torch.einsum("nlab,nlb->nla", Iw, alpha)
         + _cross(ls.omega, torch.einsum("nlab,nlb->nla", Iw, ls.omega)))
    return f, n, Iw


def bias_forces(mc: ModelConsts, ls: LinkState, axes_w, qdj, gravity) -> torch.Tensor:
    """(N, nv) generalized bias C(q, u): Coriolis, centrifugal and gravity."""
    f, n, _ = inertial_forces(mc, ls, axes_w, qdj, gravity)
    Jv, Jw = com_jacobians(mc, ls, axes_w)
    return torch.einsum("nlai,nla->ni", Jv, f) + torch.einsum("nlai,nla->ni", Jw, n)


# ---------------------------------------------------------------------------
# structured solve: base (6) + 4 independent leg (3) blocks
# ---------------------------------------------------------------------------


class MassFactors(NamedTuple):
    """Explicit inverse factors of M for repeated application."""
    Dinv: torch.Tensor   # (N, 4, 3, 3) inverse leg blocks
    B: torch.Tensor      # (N, 4, 6, 3) base-leg coupling blocks
    Sinv: torch.Tensor   # (N, 6, 6)    inverse base Schur complement
    BDinv: torch.Tensor  # (N, 4, 6, 3) B @ Dinv


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3 x 3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33], dim=-1).reshape(A.shape)
    return adj / det[..., None, None]


def _inv6(A: torch.Tensor) -> torch.Tensor:
    """6 x 6 SPD inverse by a 3 x 3 block Schur complement."""
    P, Q, S = A[..., :3, :3], A[..., :3, 3:], A[..., 3:, 3:]
    Pinv = _inv3(P)
    QtPinv = Q.transpose(-1, -2) @ Pinv
    Scinv = _inv3(S - QtPinv @ Q)
    TL = Pinv + Pinv @ Q @ Scinv @ QtPinv
    TR = -Pinv @ Q @ Scinv
    return torch.cat([torch.cat([TL, TR], dim=-1),
                      torch.cat([TR.transpose(-1, -2), Scinv], dim=-1)], dim=-2)


def factor_mass_matrix(M: torch.Tensor) -> MassFactors:
    """Factor M (N, 18, 18), quadruped dof ordering, for repeated solves."""
    N = M.shape[0]
    B = M[:, :6, 6:].reshape(N, 6, 4, 3).permute(0, 2, 1, 3)           # (N, 4, 6, 3)
    D = torch.stack([M[:, 6 + 3 * k:9 + 3 * k, 6 + 3 * k:9 + 3 * k] for k in range(4)], dim=1)
    Dinv = _inv3(D)
    BDinv = B @ Dinv
    S = M[:, :6, :6] - torch.einsum("nkab,nkcb->nac", BDinv, B)
    return MassFactors(Dinv=Dinv, B=B, Sinv=_inv6(S), BDinv=BDinv)


def solve_mass(f: MassFactors, rhs: torch.Tensor) -> torch.Tensor:
    """x = M^-1 rhs; rhs (N, 18) or (N, 18, m)."""
    vec = rhs.dim() == 2
    r = rhs[..., None] if vec else rhs
    N = r.shape[0]
    rb, rl = r[:, :6], r[:, 6:].reshape(N, 4, 3, -1)
    y = f.Dinv @ rl
    xb = f.Sinv @ (rb - torch.einsum("nkab,nkbm->nam", f.BDinv, rl))
    xl = y - f.Dinv @ torch.einsum("nkab,nam->nkbm", f.B, xb)
    x = torch.cat([xb, xl.reshape(N, 12, -1)], dim=1)
    return x[..., 0] if vec else x


def limit_impulses(mc: ModelConsts, f: MassFactors, u: torch.Tensor, dof_pos: torch.Tensor,
                   dt: float, *, iters: int = 6, relax: float = 0.8,
                   max_correction_vel: float = 1.0) -> torch.Tensor:
    """Momentum-consistent joint position/velocity limit enforcement.

    Joint velocities outside the box that keeps each joint inside its
    position limits after dt (and inside +-its velocity limit; out-of-box
    positions pushed back at <= max_correction_vel) are brought to the box
    by joint-space impulses mapped through M^-1: u' = u + M^-1 J^T j, J the
    unit rows of the violating dofs, so internal impulses change no total
    momentum.  The active set is frozen and the bilateral equality solved by
    `iters` diagonally preconditioned Jacobi sweeps on the joint block of
    M^-1, A_jj = blockdiag(D^-1) + W^T S^-1 W with W = B D^-1, assembled from
    the factors.  The integrator's residual clamp catches the rest."""
    N = u.shape[0]
    qd = u[:, 6:]
    vl = mc.dof_velocity_limit
    lo = torch.maximum(-vl, torch.clamp((mc.dof_limit_lower - dof_pos) / dt,
                                        max=max_correction_vel))
    hi = torch.minimum(vl, torch.clamp((mc.dof_limit_upper - dof_pos) / dt,
                                       min=-max_correction_vel))
    need = torch.minimum(torch.maximum(qd, lo), hi) - qd                 # (N, 12)
    active = (need.abs() > 0.0).to(u.dtype)

    W = f.BDinv.permute(0, 2, 1, 3).reshape(N, 6, 12)
    SinvW = f.Sinv @ W                                                   # (N, 6, 12)
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    dmul = lambda j: (f.Dinv @ j.reshape(N, 4, 3, 1)).reshape(N, 12)

    def A_mul(j):
        return dmul(j) + mv(W.transpose(1, 2), mv(SinvW, j))

    diag = (torch.diagonal(f.Dinv, dim1=-2, dim2=-1).reshape(N, 12)
            + torch.sum(W * SinvW, dim=1))
    j = torch.zeros_like(qd)
    for _ in range(iters):
        j = (j + relax * (need - A_mul(j)) / diag) * active
    base_du = -mv(SinvW, j)
    joint_du = dmul(j) + mv(W.transpose(1, 2), mv(f.Sinv, mv(W, j)))
    return u + torch.cat([base_du, joint_du], dim=1)
