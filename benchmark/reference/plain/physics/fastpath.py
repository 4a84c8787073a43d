"""World-frame dynamics and contact of a batch of envs (counterpart of
agility_tpu/physics/fastpath.py).

Same math as dynamics.py / contact.py with the Jacobians held transposed
and flattened, JpT (N, nv, 3S), column 3s + a = d v_s[a] / d u, and the
contact LCP run in the world frame (the cone projection against each
contact normal) instead of in per-contact frames.  The JAX module builds
these Jacobians with component-planar arithmetic and samples the terrain
window with one-hot hat contractions to suit the TPU's tiles; here JpT is
the point Jacobians transposed, and the window is sampled by the SoA
path's sampler (soa.patch_sample_hn / patch_sample_ceiling, the same
bilinear height and analytic normal).

The projected Jacobi solve runs its sweeps in kernel K1
(kernels/contact_lcp.jacobi_solve_batch): on CUDA tensors it launches the
kernel, on CPU tensors its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.plain.kernels.contact_lcp import jacobi_solve_batch
from benchmark.reference.plain.physics import heightfield as hf
from benchmark.reference.plain.physics import soa
from benchmark.reference.plain.physics.constants import ModelConsts
from benchmark.reference.plain.physics.dynamics import MassFactors, inertial_forces, solve_mass
from benchmark.reference.plain.physics.kinematics import LinkState, ix, points_jacobian, sphere_centers


def _flat_T(J):
    """(N, P, 3, nv) -> (N, nv, 3P), column 3p + a."""
    N, P, _, nv = J.shape
    return J.permute(0, 3, 1, 2).reshape(N, nv, 3 * P)


def _jacobian_T(mc: ModelConsts, ls: LinkState, axes_w, link_idx, points_w):
    """Linear-velocity Jacobian, transposed and flattened: (N, nv, 3P) for
    world points points_w (N, P, 3) attached to links link_idx (P,)."""
    return _flat_T(points_jacobian(mc, ls, axes_w, link_idx, points_w))


def _jacobian_w_T(mc: ModelConsts, ls: LinkState, axes_w, link_idx, P):
    """Angular-velocity Jacobian, transposed and flattened: (N, nv, 3P)."""
    N = ls.pos.shape[0]
    z = torch.zeros((N, P, 3, 3), dtype=ls.pos.dtype, device=ls.pos.device)
    eye = torch.eye(3, dtype=ls.pos.dtype, device=ls.pos.device).expand(N, P, 3, 3)
    m = mc.ancestors[ix(link_idx, ls.pos.device)]                      # (P, nu)
    bot = (m[:, :, None] * axes_w[:, None]).transpose(-1, -2)          # (N, P, 3, nu)
    return _flat_T(torch.cat([z, eye, bot], dim=-1))


def mass_and_bias(mc: ModelConsts, ls: LinkState, axes_w, qdj, gravity):
    """(M (N, nv, nv), C (N, nv)) from the transposed COM Jacobians."""
    N, L = ls.pos.shape[:2]
    link_idx = np.arange(L)
    JvT = _jacobian_T(mc, ls, axes_w, link_idx, ls.com)                # (N, nv, 3L)
    JwT = _jacobian_w_T(mc, ls, axes_w, link_idx, L)
    f, n, Iw = inertial_forces(mc, ls, axes_w, qdj, gravity)
    w_rep = torch.broadcast_to(mc.link_mass, (N, L)).repeat_interleave(3, dim=1)
    M = torch.einsum("nia,nja->nij", JvT * w_rep[:, None], JvT)
    JwT_I = torch.einsum("nvla,nlab->nvlb", JwT.reshape(N, -1, L, 3), Iw).reshape(N, -1, 3 * L)
    M = M + JwT_I @ JwT.transpose(1, 2)
    C = (JvT @ f.reshape(N, -1, 1) + JwT @ n.reshape(N, -1, 1))[..., 0]
    return M, C


def _patch_sample(sample, vals, patch, x, y):
    """Height (N, K) and normal (N, K, 3) from the window `vals` (N, P, P)
    through an env-minor soa sampler, at world points x, y (N, K)."""
    h, n = sample(vals.permute(1, 2, 0), patch.x0, patch.y0, patch.origin, patch.hscale,
                  x.T, y.T)
    return h.T, torch.stack(n, dim=-1).transpose(0, 1)


def detect_T(mc: ModelConsts, ls: LinkState, axes_w, grid: hf.HeightGrid, hf_weights=None,
             terrain_patch=None):
    """World-frame contact data: phi (N, S'), normals (N, S', 3), JpT
    (N, nv, 3S').  With `terrain_patch` (physics/patch.Patch, the K2 window)
    the heights and normals come from the window, else from the grid.

    Where the window has a ceiling, the leading base-link spheres (trunk and
    head) add rows against it with downward normals, S' = S + k; their
    contact points are the floor rows' points, so their Jacobian columns are
    reused."""
    centers, _ = sphere_centers(mc, ls)
    cx, cy = centers[..., 0], centers[..., 1]
    if terrain_patch is not None:
        h, n = _patch_sample(soa.patch_sample_hn, terrain_patch.values, terrain_patch, cx, cy)
    else:
        h = hf.sample_height(grid, cx, cy, hf_weights)
        n = hf.sample_normal(grid, cx, cy, hf_weights)
    phi = (centers[..., 2] - h) * n[..., 2] - mc.sph_radius
    JpT = _jacobian_T(mc, ls, axes_w, mc.sph_link, centers)
    if terrain_patch is not None and terrain_patch.ceil is not None:
        k = int(np.sum(np.asarray(mc.sph_link) == 0))
        ch, cn = _patch_sample(soa.patch_sample_ceiling, terrain_patch.ceil, terrain_patch,
                               cx[:, :k], cy[:, :k])
        phi_c = (ch - centers[:, :k, 2]) * (-cn[..., 2]) - mc.sph_radius[:k]
        phi = torch.cat([phi, phi_c], dim=1)
        n = torch.cat([n, cn], dim=1)
        JpT = torch.cat([JpT, JpT[:, :, :3 * k]], dim=2)
    return phi, n, JpT


def jacobi_solve_world(phi, normals, JpT, factors: MassFactors, u_free, mu, dt, iters=10,
                       relax=0.6, baumgarte=0.2, slop=0.002, max_depen_vel=1.0,
                       restitution=0.0, lam_max=25.0):
    """Projected block-Jacobi LCP in world coordinates, from zero impulses:
    G = JpT^T M^-1 JpT, then `iters` sweeps in K1.  Same fixed point as
    contact.jacobi_solve.  Returns (u_new (N, nv), world force (N, S, 3))."""
    MinvJT = solve_mass(factors, JpT)                                  # (N, nv, 3S)
    G = JpT.transpose(1, 2) @ MinvJT                                   # (N, 3S, 3S)
    return jacobi_solve_batch(phi, normals, JpT, MinvJT, G, u_free, mu, dt, iters=iters,
                              relax=relax, baumgarte=baumgarte, slop=slop,
                              max_depen_vel=max_depen_vel, restitution=restitution,
                              lam_max=lam_max)


def soft_forces_world(phi, normals, JpT, u, mu, kn=5000.0, cn=150.0, kt=500.0):
    """World-frame compliant contact (the model of contact.soft_forces):
    world force per sphere (N, S, 3)."""
    N, S = phi.shape
    v = (JpT.transpose(1, 2) @ u[..., None]).reshape(N, S, 3)
    vn = torch.sum(v * normals, dim=-1)
    vt = v - vn[..., None] * normals
    depth = torch.clamp(-phi, min=0.0)
    fn = torch.clamp(kn * depth - cn * vn * (depth > 0), min=0.0)
    ft_raw = -kt * vt * depth[..., None] * 50.0
    tn = torch.linalg.vector_norm(ft_raw, dim=-1, keepdim=True)
    ft = ft_raw * torch.clamp(mu.reshape(N, 1, 1) * fn[..., None]
                              / torch.clamp(tn, min=1e-9), max=1.0)
    return ft + fn[..., None] * normals
