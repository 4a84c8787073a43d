"""Env-minor ("structure of arrays") physics substep (counterpart of
agility_tpu/physics/soa.py).

States are (3, N)/(4, N)/(12, N)/(18, N) tensors, link quantities are
unrolled Python lists of (N,) component tensors, contact tensors are (S, N)
and (12, 3, S, N) — the same layout as the JAX functions, so each function
is tested against its counterpart like for like.

Same math as the JAX module:
  - FK / velocities: component arithmetic unrolled over the 13-link tree.
  - Mass matrix: composite-rigid-body algorithm about the base origin,
    factored into per-leg 3x3 inverses + a 6x6 base Schur complement.
  - Bias forces: u' = 0 acceleration propagation + subtree force sums.
  - Contact: projected block-Jacobi.  Unlike the JAX module's matrix-free
    sweep, the Delassus matrix G = J M^-1 J^T is formed once per substep
    with a batched product and the sweeps run in kernel K1
    (kernels/contact_lcp.py) — the same fixed point.  On worlds with a
    ceiling the base-link spheres add contact rows against it.
  - Terrain: the per-env window is gathered once per control step by kernel
    K2 (kernels/terrain_window.py), with the movable layers folded in.

A substep is three stages on every device: stage A (`stage_a`), the free
dynamics (`pre_contact`, through kernels/free_dynamics.py: on a CUDA device
one hand-written kernel, on the CPU pre_contact itself) and K1's inputs
(`contact_problem`); then K1 (`contact_lcp`); then stage B (`stage_b`), the
impulses applied (`apply_impulses`) and `integrate`.  On a CUDA device the
two stages replay from CUDA graphs (physics/graphs.py, FREE_DYNAMICS and
CONTACT_APPLY), each captured once for each structure, with K1 an eager
launch between them and stage B reading stage A's tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from agility_tpu_torch import trace
from agility_tpu_torch.kernels.contact_lcp import contact_lcp
from agility_tpu_torch.kernels.free_dynamics import free_dynamics
from agility_tpu_torch.kernels.terrain_window import terrain_window
from agility_tpu_torch.physics import graphs
from agility_tpu_torch.physics.constants import ModelConsts, SoAConsts, consts_of

# ---------------------------------------------------------------------------
# component-tuple helpers: Vec3 = (x, y, z), Quat = (x, y, z, w); entries are
# tensors of any broadcast-compatible shape, typically (N,) or (S, N)
# ---------------------------------------------------------------------------


def v_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def q_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def q_rot(q, v):
    """Rotate vector tuple v by quat tuple q (xyzw)."""
    u = (q[0], q[1], q[2])
    t = v_scale(v_cross(u, v), 2.0)
    return v_add(v, v_add(v_scale(t, q[3]), v_cross(u, t)))


def q_rotmat(q):
    """Quat tuple -> 3x3 nested-list rotation matrix of component tensors."""
    x, y, z, w = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]]


def q_integrate(q, w, dt, eps=1e-12):
    """Exponential-map quaternion integration by world angular velocity w."""
    wx, wy, wz = w
    angle = torch.sqrt(wx * wx + wy * wy + wz * wz)
    half = 0.5 * angle * dt
    s = torch.sin(half) / torch.clamp(angle, min=eps)
    q2 = q_mul((wx * s, wy * s, wz * s, torch.cos(half)), q)
    n = torch.clamp(torch.sqrt(q2[0] ** 2 + q2[1] ** 2 + q2[2] ** 2 + q2[3] ** 2), min=eps)
    return (q2[0] / n, q2[1] / n, q2[2] / n, q2[3] / n)


# small nested-list matrix helpers --------------------------------------------


def mat_vec(M, v):
    return tuple(sum(M[i][j] * v[j] for j in range(len(v))) for i in range(len(M)))


def mat_T(M):
    return [[M[j][i] for j in range(len(M))] for i in range(len(M[0]))]


def mat_mul(A, B):
    n, k, m = len(A), len(B), len(B[0])
    return [[sum(A[i][c] * B[c][j] for c in range(k)) for j in range(m)] for i in range(n)]


def mat_add(A, B):
    return [[A[i][j] + B[i][j] for j in range(len(A[0]))] for i in range(len(A))]


def mat_sub(A, B):
    return [[A[i][j] - B[i][j] for j in range(len(A[0]))] for i in range(len(A))]


def inv3(M):
    """Adjugate 3x3 inverse on component entries."""
    a, b, c = M[0]
    d, e, f = M[1]
    g, h, i = M[2]
    A11 = e * i - f * h
    A21 = f * g - d * i
    A31 = d * h - e * g
    r = 1.0 / (a * A11 + b * A21 + c * A31)
    return [[A11 * r, (c * h - b * i) * r, (b * f - c * e) * r],
            [A21 * r, (a * i - c * g) * r, (c * d - a * f) * r],
            [A31 * r, (b * g - a * h) * r, (a * e - b * d) * r]]


def inv6(M):
    """6x6 SPD inverse via 3x3 block Schur complement."""
    P = [row[:3] for row in M[:3]]
    Q = [row[3:] for row in M[:3]]
    S = [row[3:] for row in M[3:]]
    Pinv = inv3(P)
    QtPinv = mat_mul(mat_T(Q), Pinv)
    Scinv = inv3(mat_sub(S, mat_mul(QtPinv, Q)))
    PinvQ = mat_mul(Pinv, Q)
    TL = mat_add(Pinv, mat_mul(mat_mul(PinvQ, Scinv), QtPinv))
    TR = [[-x for x in row] for row in mat_mul(PinvQ, Scinv)]
    BL = mat_T(TR)
    return [TL[i] + TR[i] for i in range(3)] + [BL[i] + Scinv[i] for i in range(3)]


def _floats(row):
    return tuple(float(x) for x in row)


# ---------------------------------------------------------------------------
# FK + velocities (component form, tree unrolled)
# ---------------------------------------------------------------------------


def _joint_quat(c: SoAConsts, l, q_d):
    ax = _floats(c.joint_axis[l])
    half = 0.5 * q_d
    s = torch.sin(half)
    return q_mul(_floats(c.joint_quat[l]), (ax[0] * s, ax[1] * s, ax[2] * s, torch.cos(half)))


def fk_vel(c: SoAConsts, bp, bq, q, u):
    """bp: Vec3 of (N,); bq: Quat; q: (12, N); u: (18, N).  Returns a dict of
    per-link lists: pos, quat, omega, vel, and world joint axes per dof."""
    L = c.L
    pos, quat, omega, vel = [None] * L, [None] * L, [None] * L, [None] * L
    pos[0], quat[0] = bp, bq
    omega[0], vel[0] = (u[3], u[4], u[5]), (u[0], u[1], u[2])
    axes = [None] * c.nu
    for l in range(1, L):
        p = int(c.parent[l])
        d = l - 1
        quat[l] = q_mul(quat[p], _joint_quat(c, l, q[d]))
        pos[l] = v_add(pos[p], q_rot(quat[p], _floats(c.joint_pos[l])))
        axes[d] = q_rot(quat[l], _floats(c.joint_axis[l]))
        omega[l] = v_add(omega[p], v_scale(axes[d], u[6 + d]))
        vel[l] = v_add(vel[p], v_cross(omega[p], v_sub(pos[l], pos[p])))
    return dict(pos=pos, quat=quat, omega=omega, vel=vel, axes=axes)


def fk_pose(c: SoAConsts, bp, bq, q):
    """Positions/orientations only: lists of Vec3/Quat per link."""
    pos, quat = [None] * c.L, [None] * c.L
    pos[0], quat[0] = bp, bq
    for l in range(1, c.L):
        p = int(c.parent[l])
        quat[l] = q_mul(quat[p], _joint_quat(c, l, q[l - 1]))
        pos[l] = v_add(pos[p], q_rot(quat[p], _floats(c.joint_pos[l])))
    return pos, quat


def body_positions(mc: ModelConsts, s, body_idx):
    """World positions (N, K, 3) of selected reported bodies of an env-major
    EnvState."""
    c = consts_of(mc)
    pos, quat = fk_pose(c, tuple(s.base_pos.unbind(1)), tuple(s.base_quat.unbind(1)),
                        s.dof_pos.T)
    cols = []
    for b in body_idx:
        l = int(c.body_link[b])
        p = v_add(pos[l], q_rot(quat[l], _floats(c.body_offset[b])))
        cols.append(torch.stack(p, -1))
    return torch.stack(cols, 1)


def link_coms(c: SoAConsts, ls, com_shift=None):
    """World COM per link; com_shift (Vec3 of (N,)) offsets the base link."""
    com = [None] * c.L
    for l in range(c.L):
        off = _floats(c.link_com[l])
        if l == 0 and com_shift is not None:
            off = v_add(off, com_shift)
        com[l] = v_add(ls["pos"][l], q_rot(ls["quat"][l], off))
    return com


# ---------------------------------------------------------------------------
# composite-rigid-body mass matrix + structured factorization
# ---------------------------------------------------------------------------


def _world_inertia(c, ls, l):
    """R I_body R^T as nested 3x3 of (N,) tensors."""
    R = q_rotmat(ls["quat"][l])
    Ib = [[float(c.link_inertia[l][a][b]) for b in range(3)] for a in range(3)]
    return mat_mul(mat_mul(R, Ib), mat_T(R))


def _spatial_params(c, ls, com, l, added_mass=None):
    """(m, h, I) of link l about the base origin."""
    m = float(c.link_mass[l])
    if l == 0 and added_mass is not None:
        m = m + added_mass
    r = v_sub(com[l], ls["pos"][0])
    Iw = _world_inertia(c, ls, l)
    rr = v_dot(r, r)
    I = [[Iw[a][b] + (m * rr if a == b else 0.0) - m * r[a] * r[b]
          for b in range(3)] for a in range(3)]
    return m, v_scale(r, m), I


def mass_factors(c: SoAConsts, ls, com, added_mass=None):
    """Composite-CRBA mass matrix about the base origin, factored into per-leg
    3x3 inverses + the 6x6 base Schur complement (the factor dict solve()
    and limit_impulses() read)."""
    x0 = ls["pos"][0]
    sp = [_spatial_params(c, ls, com, l, added_mass) for l in range(c.L)]

    m_c, h_c, I_c = [None] * c.nu, [None] * c.nu, [None] * c.nu
    for leg in c.legs:
        for i in range(len(leg) - 1, -1, -1):
            d = leg[i]
            m, h, I = sp[d + 1]
            if i + 1 < len(leg):
                dn = leg[i + 1]
                m, h, I = m + m_c[dn], v_add(h, h_c[dn]), mat_add(I, I_c[dn])
            m_c[d], h_c[d], I_c[d] = m, h, I

    m_t, h_t, I_t = sp[0]
    for leg in c.legs:
        d = leg[0]
        m_t, h_t, I_t = m_t + m_c[d], v_add(h_t, h_c[d]), mat_add(I_t, I_c[d])

    rho, f_d, n_d = [None] * c.nu, [None] * c.nu, [None] * c.nu
    for leg in c.legs:
        for d in leg:
            a = ls["axes"][d]
            rho[d] = v_cross(v_sub(ls["pos"][d + 1], x0), a)
            f_d[d] = v_sub(v_scale(rho[d], m_c[d]), v_cross(h_c[d], a))
            n_d[d] = v_add(mat_vec(I_c[d], a), v_cross(h_c[d], rho[d]))

    z = torch.zeros_like(h_t[0])
    hx, hy, hz = h_t
    mE = [[m_t + z if i == j else z for j in range(3)] for i in range(3)]
    neg_htilde = [[z, hz, -hy], [-hz, z, hx], [hy, -hx, z]]
    A = [mE[i] + neg_htilde[i] for i in range(3)] + \
        [[neg_htilde[j][i] for j in range(3)] + I_t[i] for i in range(3)]

    Dinv, B, BDinv = [], [], []
    for leg in c.legs:
        k = len(leg)
        Dk = [[None] * k for _ in range(k)]
        Bk = [[None] * k for _ in range(6)]
        for i, d in enumerate(leg):
            for j, dd in enumerate(leg[i:], start=i):
                val = v_dot(ls["axes"][d], n_d[dd]) + v_dot(rho[d], f_d[dd])
                Dk[i][j] = val
                Dk[j][i] = val
            for r in range(3):
                Bk[r][i] = f_d[d][r]
                Bk[3 + r][i] = n_d[d][r]
        Dki = inv3(Dk)
        Dinv.append(Dki)
        B.append(Bk)
        BDinv.append(mat_mul(Bk, Dki))

    S = A
    for k in range(len(c.legs)):
        S = mat_sub(S, mat_mul(BDinv[k], mat_T(B[k])))
    return dict(Dinv=Dinv, B=B, BDinv=BDinv, Sinv=inv6(S), legs=c.legs)


def solve(f, rhs):
    """x = M^-1 rhs for a list of 18 tensors in env-minor layout."""
    legs = f["legs"]
    rl = [[rhs[6 + d] for d in leg] for leg in legs]
    y = [mat_vec(f["Dinv"][k], rl[k]) for k in range(len(legs))]
    acc = list(rhs[:6])
    for k in range(len(legs)):
        t = mat_vec(f["BDinv"][k], rl[k])
        acc = [acc[i] - t[i] for i in range(6)]
    xb = mat_vec(f["Sinv"], acc)
    out = list(xb) + [None] * sum(len(l) for l in legs)
    for k, leg in enumerate(legs):
        bt_xb = mat_vec(f["Dinv"][k], mat_vec(mat_T(f["B"][k]), xb))
        for i, d in enumerate(leg):
            out[6 + d] = y[k][i] - bt_xb[i]
    return out


def limit_impulses(c: SoAConsts, f, u_arr, q, dt, *, iters=6, relax=0.8,
                   max_correction_vel=1.0):
    """Momentum-consistent dof-limit enforcement.

    Position/velocity-limit violations are resolved with joint-space
    impulses j mapped through M^-1 (du = M^-1 [0; j]), so the base rows of
    the momentum never change: A_jj = blockdiag(D^-1) + W^T S^-1 W with
    W = B D^-1.  The post-integration hard clamp this replaces deleted limb
    momentum with no reaction on the tree.  u_arr: (18, N); q: (12, N).
    Returns the corrected (18, N)."""
    qd = u_arr[6:]
    lo = torch.maximum(-c.vel_limit, torch.clamp((c.lower - q) / dt, max=max_correction_vel))
    hi = torch.minimum(c.vel_limit, torch.clamp((c.upper - q) / dt, min=-max_correction_vel))
    need = torch.minimum(torch.maximum(qd, lo), hi) - qd                # (12, N)
    active = (torch.abs(need) > 0.0).to(u_arr.dtype)

    legs = f["legs"]
    # the stacked algebra assumes leg k owns the contiguous dof triple 3k..3k+2
    if any(list(leg) != [3 * k, 3 * k + 1, 3 * k + 2] for k, leg in enumerate(legs)):
        raise ValueError(f"limit_impulses: unsupported dof layout {legs}")
    st = lambda M: torch.stack([torch.stack(row) for row in M])
    W = torch.cat([st(f["BDinv"][k]) for k in range(len(legs))], dim=1)   # (6,12,N)
    Sinv = st(f["Sinv"])                                                  # (6,6,N)
    Dinv = torch.stack([st(f["Dinv"][k]) for k in range(len(legs))])      # (4,3,3,N)
    SinvW = torch.einsum("abn,bdn->adn", Sinv, W)                         # (6,12,N)

    def Dinv_mul(j):
        jl = j.reshape((len(legs), 3) + j.shape[1:])
        return torch.einsum("kabn,kbn->kan", Dinv, jl).reshape(j.shape)

    def A_mul(j):
        return Dinv_mul(j) + torch.einsum("abn,an->bn", W, torch.einsum("adn,dn->an", SinvW, j))

    diag = (torch.diagonal(Dinv, dim1=1, dim2=2).permute(0, 2, 1).reshape(need.shape)
            + torch.einsum("adn,adn->dn", W, SinvW))

    j = torch.zeros_like(need)
    for _ in range(iters):
        j = (j + relax * (need - A_mul(j)) / diag) * active

    Sw = torch.einsum("adn,dn->an", SinvW, j)            # = -du_base
    du_joint = Dinv_mul(j) + torch.einsum("abn,an->bn", W, Sw)
    return u_arr + torch.cat([-Sw, du_joint], dim=0)


# ---------------------------------------------------------------------------
# bias forces (u' = 0 propagation + subtree force accumulation)
# ---------------------------------------------------------------------------


def bias_forces(c: SoAConsts, ls, com, qd, gravity, added_mass=None):
    """C (list of 18 (N,) tensors): Coriolis, centrifugal and gravity terms."""
    L = c.L
    x0 = ls["pos"][0]
    z = torch.zeros_like(x0[0])
    alpha, a_frame = [None] * L, [None] * L
    alpha[0] = (z, z, z)
    a_frame[0] = (z - gravity[0], z - gravity[1], z - gravity[2])
    for l in range(1, L):
        p = int(c.parent[l])
        r = v_sub(ls["pos"][l], ls["pos"][p])
        wp = ls["omega"][p]
        a_frame[l] = v_add(a_frame[p], v_add(v_cross(alpha[p], r), v_cross(wp, v_cross(wp, r))))
        alpha[l] = v_add(alpha[p], v_scale(v_cross(wp, ls["axes"][l - 1]), qd[l - 1]))

    tau_l, f_l = [None] * L, [None] * L
    for l in range(L):
        m = float(c.link_mass[l])
        if l == 0 and added_mass is not None:
            m = m + added_mass
        coff = v_sub(com[l], ls["pos"][l])
        w = ls["omega"][l]
        a_com = v_add(a_frame[l], v_add(v_cross(alpha[l], coff), v_cross(w, v_cross(w, coff))))
        f = v_scale(a_com, m)
        Iw = _world_inertia(c, ls, l)
        n = v_add(mat_vec(Iw, alpha[l]), v_cross(w, mat_vec(Iw, w)))
        f_l[l] = f
        tau_l[l] = v_add(n, v_cross(v_sub(com[l], x0), f))

    C = [None] * (6 + c.nu)
    f_tot, tau_tot = f_l[0], tau_l[0]
    for leg in c.legs:
        f_c, tau_c = None, None
        for i in range(len(leg) - 1, -1, -1):
            d = leg[i]
            l = d + 1
            f_c = f_l[l] if f_c is None else v_add(f_c, f_l[l])
            tau_c = tau_l[l] if tau_c is None else v_add(tau_c, tau_l[l])
            a = ls["axes"][d]
            rho = v_cross(v_sub(ls["pos"][l], x0), a)
            C[6 + d] = v_dot(a, tau_c) + v_dot(rho, f_c)
        f_tot, tau_tot = v_add(f_tot, f_c), v_add(tau_tot, tau_c)
    C[0], C[1], C[2] = f_tot
    C[3], C[4], C[5] = tau_tot
    return C


# ---------------------------------------------------------------------------
# contact: geometry, Jacobian products, Delassus blocks, K1 solve
# ---------------------------------------------------------------------------


def sphere_geometry(c: SoAConsts, ls):
    """Centres (3-tuple of (S, N)) plus lever table (12, 3, S, N):
    lever[d, :, s] = ancestors(d, link_s) * a_d x (c_s - p_d)."""
    cen = [v_add(ls["pos"][int(c.sph_link[s])],
                 q_rot(ls["quat"][int(c.sph_link[s])], _floats(c.sph_offset[s])))
           for s in range(c.S)]
    cen = tuple(torch.stack([p[k] for p in cen]) for k in range(3))
    rows = []
    for d in range(c.nu):
        a = ls["axes"][d]
        pd = ls["pos"][int(c.dof_link[d])]
        dx, dy, dz = (cen[k] - pd[k][None] for k in range(3))
        m = c.lever_mask[:, d][:, None]
        rows.append(torch.stack([(a[1][None] * dz - a[2][None] * dy) * m,
                                 (a[2][None] * dx - a[0][None] * dz) * m,
                                 (a[0][None] * dy - a[1][None] * dx) * m]))
    return cen, torch.stack(rows)


def apply_JT(lam, r, lever):
    """tau (18-list of (N,)) = J^T lam;  lam (3, S, N), r tuple of (S, N)."""
    tau_lin = torch.sum(lam, dim=1)
    rx, ry, rz = r
    tx = torch.sum(ry * lam[2] - rz * lam[1], dim=0)
    ty = torch.sum(rz * lam[0] - rx * lam[2], dim=0)
    tz = torch.sum(rx * lam[1] - ry * lam[0], dim=0)
    tau_j = torch.sum(lever * lam[None], dim=(1, 2))
    return [tau_lin[0], tau_lin[1], tau_lin[2], tx, ty, tz] + list(tau_j.unbind(0))


def apply_J(w, r, lever):
    """v (3, S, N) = J w for w an 18-list of (N,)."""
    wl = torch.stack(w[0:3])[:, None, :]
    wa = (w[3], w[4], w[5])
    rx, ry, rz = r
    wxr = torch.stack([wa[1][None] * rz - wa[2][None] * ry,
                       wa[2][None] * rx - wa[0][None] * rz,
                       wa[0][None] * ry - wa[1][None] * rx])
    vj = torch.sum(lever * torch.stack(w[6:])[:, None, None, :], dim=0)
    return wl + wxr + vj


def jacobian_minv(f, r, lever):
    """Contact Jacobian J and X = M^-1 J^T, both as (18, 3, S, N): row v is
    the contact-velocity response to dof v."""
    z = torch.zeros_like(r[0])
    o = torch.ones_like(r[0])
    rx, ry, rz = r
    J = [(o, z, z), (z, o, z), (z, z, o),
         (z, -rz, ry), (rz, z, -rx), (-ry, rx, z)]
    J += [(lever[d, 0], lever[d, 1], lever[d, 2]) for d in range(lever.shape[0])]
    J = [torch.stack(row) for row in J]
    return torch.stack(J), torch.stack(solve(f, J))


def _diag_inv(J, X):
    """Per-contact inverse 3x3 diagonal blocks of G = J M^-1 J^T (+1e-6 reg)."""
    D = [[torch.sum(J[:, a] * X[:, b], dim=0) + (1e-6 if a == b else 0.0)
          for b in range(3)] for a in range(3)]
    return inv3(D)


def delassus_diag_inv(f, r, lever):
    """Nested [3][3] list of (S, N) inverse diagonal blocks of G."""
    return _diag_inv(*jacobian_minv(f, r, lever))


def _env_major(x):
    """(3, S, N) -> (N, 3S), index 3*s + a (the K1 layout)."""
    return x.permute(2, 1, 0).reshape(x.shape[2], -1)


def contact_problem(phi, n, r, lever, f, u_free, mu, dt, *, baumgarte, slop,
                    max_depen_vel, restitution, lam0=None):
    """The inputs of K1 (kernels/contact_lcp.py, env-major layout) for one
    substep: G, vf, bias, n, act, dinv, mu, lam0."""
    S, N = phi.shape
    active = (phi < 0.0).to(phi.dtype)
    nx, ny, nz = n
    J, X = jacobian_minv(f, r, lever)
    Dinv = _diag_inv(J, X)
    Jm = J.permute(3, 2, 1, 0).reshape(N, 3 * S, -1)       # (N, 3S, 18)
    Xm = X.permute(3, 2, 1, 0).reshape(N, 3 * S, -1)
    G = torch.bmm(Jm, Xm.transpose(1, 2))                   # (N, 3S, 3S)

    depth = torch.clamp(-phi - slop, min=0.0)
    bias_n = torch.clamp(baumgarte / dt * depth, max=max_depen_vel)
    v_free = apply_J(u_free, r, lever)
    vn0 = v_free[0] * nx + v_free[1] * ny + v_free[2] * nz
    bias_n = bias_n + restitution * torch.clamp(-vn0, min=0.0)
    bias = torch.stack([bias_n * nx, bias_n * ny, bias_n * nz])

    dinv = torch.stack([torch.stack(row) for row in Dinv]).permute(3, 2, 0, 1)
    mu_e = mu[:, None].expand(N, S) if mu.dim() == 1 else mu.T
    lam0_e = (torch.zeros((N, 3 * S), dtype=phi.dtype, device=phi.device)
              if lam0 is None else _env_major(lam0))
    return (G, _env_major(v_free), _env_major(bias), _env_major(torch.stack(n)),
            active.T.contiguous(), dinv.reshape(N, S, 9).contiguous(), mu_e.contiguous(),
            lam0_e)


def jacobi_solve(phi, n, r, lever, f, u_free, mu, dt, *, iters, relax, baumgarte,
                 slop, max_depen_vel, restitution, lam_max=25.0, lam0=None):
    """Projected block-Jacobi contact solve through K1: same fixed point and
    returns as the JAX soa.jacobi_solve — (u_new 18-list, force (3, S, N),
    lam (3, S, N)).  With `lam0` the sweeps start from project(lam0).  The
    substep runs the same three steps (contact_problem, K1, apply_impulses)
    across its stages."""
    S, N = phi.shape
    args = contact_problem(phi, n, r, lever, f, u_free, mu, dt, baumgarte=baumgarte,
                           slop=slop, max_depen_vel=max_depen_vel,
                           restitution=restitution, lam0=lam0)
    lam = contact_lcp(*args, iters=iters, relax=relax, lam_max=lam_max)
    return apply_impulses(lam, r, lever, f, u_free, dt)


def apply_impulses(lam, r, lever, f, u_free, dt):
    """K1's impulses lam (N, 3S) onto the free velocity: (u_new 18-list,
    force (3, S, N), lam (3, S, N))."""
    S, N = r[0].shape
    lam = lam.view(N, S, 3).permute(2, 1, 0)                # (3, S, N)
    w = solve(f, apply_JT(lam, r, lever))
    return [u_free[i] + w[i] for i in range(18)], lam / dt, lam


# ---------------------------------------------------------------------------
# batched patch sampling (env-minor): heights + normals for all spheres
# ---------------------------------------------------------------------------


def patch_sample_hn(patch_vals_T, patch_x0, patch_y0, origin, hscale, x, y):
    """Bilinear height + analytic normal at (x, y) (S, N) from per-env
    patches; patch_vals_T is (P, P, N)."""
    P = patch_vals_T.shape[0]
    gx = torch.clamp((x - origin[0]) / hscale - patch_x0[None].to(x.dtype), 0.0, P - 1.001)
    gy = torch.clamp((y - origin[1]) / hscale - patch_y0[None].to(x.dtype), 0.0, P - 1.001)
    idx = torch.arange(P, dtype=x.dtype, device=x.device)[None, :, None]
    dx = gx[:, None, :] - idx
    dy = gy[:, None, :] - idx
    wx = torch.clamp(1.0 - torch.abs(dx), min=0.0)
    wy = torch.clamp(1.0 - torch.abs(dy), min=0.0)

    def dhat(d):
        return (torch.where((d > 0) & (d < 1), -1.0, 0.0)
                + torch.where((d <= 0) & (d > -1), 1.0, 0.0)).to(x.dtype)

    rows = torch.einsum("spn,pqn->sqn", wx, patch_vals_T)
    drows = torch.einsum("spn,pqn->sqn", dhat(dx), patch_vals_T)
    h = torch.sum(rows * wy, dim=1)
    dhdx = torch.sum(drows * wy, dim=1) / hscale
    dhdy = torch.sum(rows * dhat(dy), dim=1) / hscale
    inv = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, (-dhdx * inv, -dhdy * inv, inv)


def patch_sample_ceiling(ceil_vals_T, patch_x0, patch_y0, origin, hscale, x, y):
    """Ceiling height + DOWNWARD surface normal at (x, y): the outward
    normal of a solid that lies above z = c(x, y), the negation of the
    floor-style normal of the same surface."""
    h, n = patch_sample_hn(ceil_vals_T, patch_x0, patch_y0, origin, hscale, x, y)
    return h, (-n[0], -n[1], -n[2])


class PatchSampler(NamedTuple):
    """`sampler(x, y)` -> (h (S, N), n Vec3 of (S, N)) over a per-env terrain
    window: `patch_sample_hn`, or with `ceiling` `patch_sample_ceiling`.  It
    holds its tensors, so that the substep's graph can copy them in."""
    values_T: torch.Tensor      # (P, P, N)
    x0: torch.Tensor            # (N,) the window's first cell on the grid
    y0: torch.Tensor
    origin: tuple               # the grid's (x, y) of node (0, 0)
    hscale: float
    ceiling: bool = False

    def __call__(self, x, y):
        sample = patch_sample_ceiling if self.ceiling else patch_sample_hn
        return sample(self.values_T, self.x0, self.y0, self.origin, self.hscale, x, y)


# ---------------------------------------------------------------------------
# substep + control step
# ---------------------------------------------------------------------------


class SoAState(NamedTuple):
    bp: torch.Tensor    # (3, N)
    bq: torch.Tensor    # (4, N)
    q: torch.Tensor     # (12, N)
    u: torch.Tensor     # (18, N)


def pre_contact(mc: ModelConsts, cfg, sd: SoAState, target, kp, kd, prm, sampler,
                ceil_sampler=None):
    """A substep up to the contact solve: PD torques, the factored mass
    matrix, the unconstrained velocity and the contact geometry.  With
    `ceil_sampler` the base-link spheres (the first c.n_ceil) also get
    contact rows against the overhead surface, with downward normals.
    Returns a dict with f, u_free, phi, n, r, lever, tau_j, tau_org.  The
    plain twin of kernels/free_dynamics.py, which stage A runs on a card and
    which gives its bits."""
    c = consts_of(mc)
    bp = tuple(sd.bp.unbind(0))
    ls = fk_vel(c, bp, tuple(sd.bq.unbind(0)), sd.q, sd.u)
    com = link_coms(c, ls, prm.get("com_shift"))

    tau_org = prm["kp_scale"] * kp * (target - sd.q) - prm["kd_scale"] * kd * sd.u[6:]
    tau_j = torch.minimum(torch.maximum(tau_org, -c.effort), c.effort)

    f = mass_factors(c, ls, com, prm.get("added_mass"))
    C = bias_forces(c, ls, com, list(sd.u[6:].unbind(0)), cfg.gravity, prm.get("added_mass"))
    du = solve(f, [-C[i] for i in range(6)] + [tau_j[d] - C[6 + d] for d in range(c.nu)])
    u_free = [sd.u[i] + cfg.dt * du[i] for i in range(18)]

    cen, lever = sphere_geometry(c, ls)
    h, n = sampler(cen[0], cen[1])
    phi = (cen[2] - h) * n[2] - c.sph_radius
    r = tuple(cen[k] - bp[k][None] for k in range(3))
    if ceil_sampler is not None:
        k = c.n_ceil
        ch, cn = ceil_sampler(cen[0][:k], cen[1][:k])
        # gap below an overhead surface: positive while clear of the roof
        phi_c = (ch - cen[2][:k]) * (-cn[2]) - c.sph_radius[:k]
        phi = torch.cat([phi, phi_c], dim=0)
        n = tuple(torch.cat([n[i], cn[i]], dim=0) for i in range(3))
        r = tuple(torch.cat([r[i], r[i][:k]], dim=0) for i in range(3))
        lever = torch.cat([lever, lever[:, :, :k]], dim=2)
    return dict(f=f, u_free=u_free, phi=phi, n=n, r=r, lever=lever, tau_j=tau_j,
                tau_org=tau_org)


FREE_DYNAMICS = graphs.GraphCache()     # stage A's graphs: `captures`, `replays`
CONTACT_APPLY = graphs.GraphCache()     # stage B's


def stage_a(mc: ModelConsts, cfg, sd: SoAState, target, kp, kd, prm, sampler,
            ceil_sampler=None):
    """The substep up to K1: pre_contact's results (`free_dynamics`: the
    kernel on a CUDA device), with K1's inputs from zero impulses under
    `problem` (contact_problem's tuple) and the state read under `state`."""
    p = free_dynamics(mc, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler)
    p["problem"] = contact_problem(p["phi"], p["n"], p["r"], p["lever"], p["f"], p["u_free"],
                                   prm["friction"], cfg.dt, **contact_kwargs(cfg))
    p["state"] = sd
    return p


def stage_b(mc: ModelConsts, cfg, p, lam):
    """The substep after K1: its impulses lam (N, 3S) applied to stage A's
    results `p` and the substep integrated.  Returns (SoAState, force
    (3, S, N))."""
    u_new, force, _ = apply_impulses(lam, p["r"], p["lever"], p["f"], p["u_free"], cfg.dt)
    return integrate(consts_of(mc), cfg, p["state"], p["f"], u_new), force


def contact_kwargs(cfg):
    """The contact-solve settings of an EngineConfig."""
    return dict(baumgarte=cfg.baumgarte, slop=cfg.contact_slop,
                max_depen_vel=cfg.max_depenetration_vel, restitution=cfg.restitution)


@trace.spanned("engine.substep")
def substep(mc: ModelConsts, cfg, sd: SoAState, target, kp, kd, prm, sampler,
            ceil_sampler=None, lam0=None):
    """One physics substep in env-minor layout: stage A through
    FREE_DYNAMICS, K1 (`contact_lcp`, eager, from lam0 where given), stage B
    through CONTACT_APPLY, reading stage A's results in place.

    target/kp/kd: (12, N); prm: dict of env-minor randomization tensors
    (kp_scale/kd_scale (12, N), friction (N,), added_mass (N,), com_shift
    Vec3 of (N,)); sampler: the PatchSampler of the terrain; ceil_sampler
    that of the ceiling, or None.
    Returns (SoAState, (tau, tau_org) (12, N), force (3, S', N), lam), with
    S' = S plus the ceiling rows.  On a CUDA device the stages replay from
    CUDA graphs (physics/graphs.py), both under one key of the inputs'
    structure, the model, `cfg` and the matmul precision: the state, tau,
    tau_org and force are then the graphs' tensors, overwritten by the next
    substep, and lam is K1's own."""
    inputs, samplers = (sd, target, kp, kd, prm), (sampler, ceil_sampler)
    with trace.span("engine.free_dynamics"):
        key = graphs.key((inputs, samplers), id(mc), cfg, torch.backends.cuda.matmul.allow_tf32)
        p = FREE_DYNAMICS(key, mc, lambda a, s: stage_a(mc, cfg, *a, *s), inputs, samplers)
    problem = p["problem"]
    if lam0 is not None:
        # a warm start (the previous substep's K1 output) outside the graph:
        # one graph serves every substep
        problem = problem[:7] + (_env_major(lam0),)
    with trace.span("engine.contact"):
        # the module's name, looked up at each call: outside any graph
        lam = contact_lcp(*problem, iters=cfg.jacobi_iters, relax=cfg.jacobi_relax)
    with trace.span("engine.integrate"):
        sd2, force = CONTACT_APPLY(key, mc, lambda a, _: stage_b(mc, cfg, p, a), lam, borrowed=p)
    S, N = p["phi"].shape
    return sd2, (p["tau_j"], p["tau_org"]), force, lam.view(N, S, 3).permute(2, 1, 0)


def integrate(c: SoAConsts, cfg, sd: SoAState, f, u_new) -> SoAState:
    """The substep's integration: base-velocity backstop, limit impulses,
    semi-implicit Euler, then the residual joint clamp — in that order."""
    u_arr = torch.stack(u_new)
    u_arr = torch.cat([torch.clamp(u_arr[0:3], -100.0, 100.0),
                       torch.clamp(u_arr[3:6], -50.0, 50.0), u_arr[6:]])
    if cfg.enforce_joint_limits:
        u_arr = limit_impulses(c, f, u_arr, sd.q, cfg.dt)
    bp2 = sd.bp + cfg.dt * u_arr[0:3]
    bq2 = torch.stack(q_integrate(tuple(sd.bq.unbind(0)), (u_arr[3], u_arr[4], u_arr[5]),
                                  cfg.dt))
    q2 = sd.q + cfg.dt * u_arr[6:]
    qd2 = u_arr[6:]
    if cfg.enforce_joint_limits:
        q2c = torch.minimum(torch.maximum(q2, c.lower), c.upper)
        qd2 = torch.where(q2c == q2, qd2, 0.0)
        q2 = q2c
        qd2 = torch.minimum(torch.maximum(qd2, -c.vel_limit), c.vel_limit)
    return SoAState(bp=bp2, bq=bq2, q=q2, u=torch.cat([u_arr[:6], qd2], dim=0))


def batch_inputs(cfg, grid, s, control, params):
    """Env-major EnvState/Control/EnvParams -> the env-minor substep inputs:
    (SoAState, (target, kp, kd, prm, sampler, ceil_sampler), terrain_patch).
    The terrain window is gathered once here, through K2, with the env's
    `params.hf_weights` folded in, and sampled by every substep;
    ceil_sampler is None where the grid has no ceiling."""
    sd = SoAState(bp=s.base_pos.T, bq=s.base_quat.T, q=s.dof_pos.T, u=s.u.T)
    prm = dict(kp_scale=params.kp_scale.T, kd_scale=params.kd_scale.T,
               friction=params.friction, added_mass=params.added_base_mass,
               com_shift=tuple(params.base_com_shift.unbind(1)))
    with trace.span("engine.terrain_window"):
        patch = terrain_window(grid, s.base_pos[:, :2].contiguous(), cfg.patch_size,
                               params.hf_weights)
    sampler = PatchSampler(patch.values.permute(1, 2, 0), patch.x0, patch.y0, grid.origin,
                           grid.hscale)
    ceil_sampler = None
    if patch.ceil is not None:
        ceil_sampler = sampler._replace(values_T=patch.ceil.permute(1, 2, 0), ceiling=True)
    return sd, (control.target.T, control.kp.T, control.kd.T, prm, sampler,
                ceil_sampler), patch


def control_step_batched(mc: ModelConsts, cfg, grid, s, control, params):
    """`cfg.decimation` substeps on env-major batched EnvState/Control/
    EnvParams.  Returns (state, (tau, tau_org) (N, 12), body_forces (N, B, 3),
    max_body_forces (N, B, 3), terrain_patch)."""
    from agility_tpu_torch.physics.engine import EnvState

    c = consts_of(mc)
    sd, args, terrain_patch = batch_inputs(cfg, grid, s, control, params)
    body_mat = c.body_mat
    if args[-1] is not None:
        # ceiling contact rows accumulate onto the same base-link bodies
        body_mat = torch.cat([body_mat, body_mat[:, :c.n_ceil]], dim=1)
    lam = None
    bf_all = []
    for _ in range(cfg.decimation):
        sd, taus, force, lam_new = substep(mc, cfg, sd, *args, lam0=lam)
        if cfg.warm_start:
            lam = lam_new
        bf_all.append(torch.einsum("bs,asn->ban", body_mat, force))     # (B, 3, N)
    body_forces = bf_all[-1].permute(2, 0, 1)
    max_body_forces = torch.stack(bf_all).abs().amax(dim=0).permute(2, 0, 1)
    # cloned: on the graph path they are the graphs', which the next step
    # overwrites, and the env, the trainers and the harness keep them
    state = EnvState(base_pos=sd.bp.T.clone(), base_quat=sd.bq.T.clone(),
                     dof_pos=sd.q.T.clone(), u=sd.u.T.clone())
    taus = (taus[0].T.clone(), taus[1].T.clone())
    return state, taus, body_forces, max_body_forces, terrain_patch
