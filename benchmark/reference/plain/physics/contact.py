"""Contact detection and resolution of a batch of envs in per-contact
frames (counterpart of agility_tpu/physics/contact.py).

Three solvers over the same sphere-vs-heightfield detection, all plain
torch:
  * `pgs_solve`   projected block Gauss-Seidel over per-contact 3 x 3 blocks,
                  serial over the S contacts inside each sweep (the order
                  matters), batched over envs;
  * `jacobi_solve` projected block Jacobi on the full (3S x 3S) Delassus
                  matrix, every contact at once;
  * `soft_forces` compliant contact: a normal spring-damper and cone-clamped
                  viscous friction.
Every sphere is always a contact with an activity mask, so shapes are
static.  Every tensor has a leading env axis N; mu is (N,).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.physics import heightfield as hf
from benchmark.reference.plain.physics.constants import ModelConsts
from benchmark.reference.plain.physics.dynamics import MassFactors, _inv3, solve_mass
from benchmark.reference.plain.physics.kinematics import (LinkState, _cross, points_jacobian,
                                                  sphere_centers)


class Contacts(NamedTuple):
    phi: torch.Tensor      # (N, S) signed distance (negative = penetrating)
    frame: torch.Tensor    # (N, S, 3, 3) rows [t1, t2, n], world
    Jc: torch.Tensor       # (N, S, 3, nv) contact-frame point Jacobian
    centers: torch.Tensor  # (N, S, 3)


def detect(mc: ModelConsts, ls: LinkState, axes_w, grid: hf.HeightGrid,
           hf_weights=None) -> Contacts:
    """Sphere-vs-heightfield narrow phase, contact frames and Jacobians."""
    centers, _ = sphere_centers(mc, ls)
    cx, cy = centers[..., 0], centers[..., 1]
    h = hf.sample_height(grid, cx, cy, hf_weights)
    n = hf.sample_normal(grid, cx, cy, hf_weights)
    # distance along the surface normal from the (locally planar) surface
    phi = (centers[..., 2] - h) * n[..., 2] - mc.sph_radius
    # tangent basis: t1 = normalize(x - (x.n) n), t2 = n x t1
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    t1 = ex - n * n[..., 0:1]
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    frame = torch.stack([t1, _cross(n, t1), n], dim=-2)               # (N, S, 3, 3)
    # point Jacobians at the sphere centres (the radius lever along n is
    # negligible at these sphere sizes)
    Jp = points_jacobian(mc, ls, axes_w, mc.sph_link, centers)
    return Contacts(phi=phi, frame=frame, Jc=frame @ Jp, centers=centers)


def _bias(phi, vn, dt, baumgarte, slop, max_depen_vel, restitution):
    """Normal velocity bias (N, S): Baumgarte push-out (capped) plus restitution."""
    depth = torch.clamp(-phi - slop, min=0.0)
    bias_n = torch.clamp(baumgarte / dt * depth, max=max_depen_vel)
    return bias_n + restitution * torch.clamp(-vn, min=0.0)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def pgs_solve(con: Contacts, factors: MassFactors, u_free, mu, dt: float, iters: int = 4,
              baumgarte: float = 0.2, slop: float = 0.002, max_depen_vel: float = 1.0,
              restitution: float = 0.0):
    """Projected block Gauss-Seidel over the contact impulses lam (N, S, 3)
    in contact frames, such that v+ = Jc (u_free + M^-1 Jc^T lam),
    0 <= lam_n  perp  v_n+ + bias >= 0 and |lam_t| <= mu lam_n.  Contacts are
    swept in order, each seeing the velocity its predecessors left.
    Returns (u_new, lam, world force (N, S, 3))."""
    N, S, _, nv = con.Jc.shape
    active = (con.phi < 0.0).to(u_free.dtype)
    JcT = con.Jc.reshape(N, 3 * S, nv).transpose(1, 2)                 # (N, nv, 3S)
    MinvJcT = solve_mass(factors, JcT).reshape(N, nv, S, 3).permute(0, 2, 1, 3)  # (N, S, nv, 3)
    G = con.Jc @ MinvJcT                                              # (N, S, 3, 3)
    Ginv = _inv3(G + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device))
    v0_n = _mv(con.Jc, u_free[:, None].expand(N, S, nv))[..., 2]
    bias_n = _bias(con.phi, v0_n, dt, baumgarte, slop, max_depen_vel, restitution)
    mu = mu.reshape(N)
    u = u_free
    lam = [torch.zeros((N, 3), dtype=u.dtype, device=u.device) for _ in range(S)]
    for _ in range(iters):
        for s in range(S):
            v = _mv(con.Jc[:, s], u)
            v = torch.cat([v[:, :2], v[:, 2:] - bias_n[:, s, None]], dim=1)
            new = lam[s] - _mv(Ginv[:, s], v)
            ln = torch.clamp(new[:, 2], min=0.0) * active[:, s]
            lt = new[:, :2]
            tn = torch.linalg.vector_norm(lt, dim=-1)
            scale = torch.clamp(mu * ln / torch.clamp(tn, min=1e-9), max=1.0)
            new = torch.cat([lt * (scale * active[:, s])[:, None], ln[:, None]], dim=1)
            u = u + _mv(MinvJcT[:, s], new - lam[s])
            lam[s] = new
    lam = torch.stack(lam, dim=1)
    return u, lam, torch.einsum("nsab,nsa->nsb", con.frame, lam) / dt


def _project_frame(lam, active, mu):
    """Friction-cone projection of contact-frame impulses (N, S, 3)."""
    ln = torch.clamp(lam[..., 2], min=0.0) * active
    lt = lam[..., :2]
    tn = torch.linalg.vector_norm(lt, dim=-1)
    scale = torch.clamp(mu[:, None] * ln / torch.clamp(tn, min=1e-9), max=1.0)
    return torch.cat([lt * (scale * active)[..., None], ln[..., None]], dim=-1)


def jacobi_solve(con: Contacts, factors: MassFactors, u_free, mu, dt: float, iters: int = 10,
                 relax: float = 0.35, baumgarte: float = 0.2, slop: float = 0.002,
                 max_depen_vel: float = 1.0, restitution: float = 0.0):
    """Block-preconditioned projected Jacobi on the full contact LCP in
    contact frames: each sweep is one (3S x 3S) Delassus product and a
    parallel per-contact 3 x 3 block step with the cone projection and
    under-relaxation.  Same fixed point as `pgs_solve`.
    Returns (u_new, lam (N, S, 3), world force (N, S, 3))."""
    N, S, _, nv = con.Jc.shape
    active = (con.phi < 0.0).to(u_free.dtype)
    J = con.Jc.reshape(N, 3 * S, nv)
    MinvJcT = solve_mass(factors, J.transpose(1, 2))                  # (N, nv, 3S)
    G = J @ MinvJcT                                                   # (N, 3S, 3S)
    diag = torch.diagonal(G.reshape(N, S, 3, S, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    Dinv = _inv3(diag + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device))
    v_free = _mv(J, u_free).reshape(N, S, 3)
    bias_n = _bias(con.phi, v_free[..., 2], dt, baumgarte, slop, max_depen_vel, restitution)
    rhs = torch.cat([v_free[..., :2], (v_free[..., 2] - bias_n)[..., None]], dim=-1)
    mu = mu.reshape(N)
    lam = torch.zeros((N, S, 3), dtype=u_free.dtype, device=u_free.device)
    for _ in range(iters):
        v = _mv(G, lam.reshape(N, 3 * S)).reshape(N, S, 3) + rhs
        lam = _project_frame(lam - relax * _mv(Dinv, v), active, mu)
    u_new = u_free + _mv(MinvJcT, lam.reshape(N, 3 * S))
    return u_new, lam, torch.einsum("nsab,nsa->nsb", con.frame, lam) / dt


def soft_forces(con: Contacts, u, mu, kn: float = 5000.0, cn: float = 150.0,
                kt: float = 500.0):
    """Compliant contact: world force per sphere (N, S, 3)."""
    N, S, _, nv = con.Jc.shape
    v = _mv(con.Jc, u[:, None].expand(N, S, nv))                      # contact frame
    depth = torch.clamp(-con.phi, min=0.0)
    fn = torch.clamp(kn * depth - cn * v[..., 2] * (depth > 0), min=0.0)
    ft_raw = -kt * v[..., :2] * depth[..., None] * 50.0              # stiff viscous
    tn = torch.linalg.vector_norm(ft_raw, dim=-1, keepdim=True)
    ft = ft_raw * torch.clamp(mu.reshape(N, 1, 1) * fn[..., None]
                              / torch.clamp(tn, min=1e-9), max=1.0)
    return torch.einsum("nsab,nsa->nsb", con.frame, torch.cat([ft, fn[..., None]], dim=-1))
