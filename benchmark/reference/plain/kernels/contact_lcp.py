"""K1, the contact LCP solve, in plain torch on every device: a frozen copy
of the plain twin beside the port's CUDA kernel
(agility_tpu_torch/kernels/contact_lcp.py)."""
from __future__ import annotations

import torch


def _project(lam, n, act, mu, lam_max):
    """Friction-cone projection on (N, S, 3) impulses."""
    ln = torch.sum(lam * n, dim=-1)
    lt = lam - ln[..., None] * n
    ln = torch.clamp(ln, 0.0, lam_max) * act
    tn = torch.linalg.vector_norm(lt, dim=-1)
    scale = torch.clamp(mu * ln / torch.clamp(tn, min=1e-9), max=1.0) * act
    return lt * scale[..., None] + ln[..., None] * n


def contact_lcp_reference(G, vf, bias, n, act, dinv, mu, lam0, *, iters: int,
                          relax: float, lam_max: float = 25.0):
    """Plain-torch K1: `iters` projected block-Jacobi sweeps from project(lam0)."""
    N, M = vf.shape
    S = M // 3
    n3 = n.view(N, S, 3)
    D = dinv.view(N, S, 3, 3)
    rhs = vf - bias
    lam = _project(lam0.view(N, S, 3), n3, act, mu, lam_max)
    for _ in range(iters):
        v = (torch.bmm(G, lam.reshape(N, M, 1))[..., 0] + rhs).view(N, S, 3)
        dl = -torch.einsum("nsab,nsb->nsa", D, v)
        lam = _project(lam + relax * dl, n3, act, mu, lam_max)
    return lam.reshape(N, M)


def per_env_problem(phi, normals, JpT, G, u_free, mu, dt, *, baumgarte=0.2, slop=0.002,
                    max_depen_vel=1.0, restitution=0.0):
    """K1's eight inputs for a cold solve from the per-env engine's world-frame
    contact data: phi (N, S), normals (N, S, 3), JpT (N, nv, 3S), G = JpT^T
    M^-1 JpT (N, 3S, 3S), u_free (N, nv), mu (N,).  The velocity bias lies
    along the normals; dinv inverts G's 3 x 3 diagonal blocks + 1e-6 I."""
    from benchmark.reference.plain.physics.dynamics import _inv3

    N, S = phi.shape
    M = 3 * S
    active = (phi < 0.0).to(u_free.dtype)
    v_free = (JpT.transpose(1, 2) @ u_free[..., None])[..., 0]         # (N, 3S)
    vn0 = torch.sum(v_free.view(N, S, 3) * normals, dim=-1)
    depth = torch.clamp(-phi - slop, min=0.0)
    bias_n = torch.clamp(baumgarte / dt * depth, max=max_depen_vel)
    bias_n = bias_n + restitution * torch.clamp(-vn0, min=0.0)
    diag = torch.diagonal(G.view(N, S, 3, S, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    dinv = _inv3(diag + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device))
    return (G.contiguous(), v_free.contiguous(), (bias_n[..., None] * normals).reshape(N, M),
            normals.reshape(N, M).contiguous(), active.contiguous(),
            dinv.reshape(N, S, 9).contiguous(), mu.reshape(N, 1).expand(N, S).contiguous(),
            torch.zeros_like(v_free))


def jacobi_solve_batch(phi, normals, JpT, MinvJT, G, u_free, mu, dt, *, iters=10, relax=0.6,
                       baumgarte=0.2, slop=0.002, max_depen_vel=1.0, restitution=0.0,
                       lam_max=25.0):
    """The per-env engine's contact solve through K1, cold (lam0 = 0):
    `iters` sweeps on `per_env_problem`'s inputs, MinvJT = M^-1 JpT.
    Returns (u_new = u_free + MinvJT lam, the world force lam / dt (N, S, 3))."""
    N, S = phi.shape
    args = per_env_problem(phi, normals, JpT, G, u_free, mu, dt, baumgarte=baumgarte,
                           slop=slop, max_depen_vel=max_depen_vel, restitution=restitution)
    lam = contact_lcp_reference(*args, iters=iters, relax=relax, lam_max=lam_max)
    return u_free + (MinvJT @ lam[..., None])[..., 0], lam.view(N, S, 3) / dt

contact_lcp = contact_lcp_reference
