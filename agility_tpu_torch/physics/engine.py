"""The batched simulation engine (counterpart of agility_tpu/physics/engine.py).

PD actuation -> forward dynamics -> contact solve -> semi-implicit
integration, `decimation` substeps per control step.  Two formulations of
the same physics, chosen by `step_batch` from the EngineConfig as the JAX
package chooses them:

  * the env-minor SoA path (physics/soa.py): component-unrolled algebra with
    the warm-started projected Jacobi contact solve in kernel K1; the
    default, and the only one with overhang (ceiling) contacts on every
    grid;
  * the per-env path (`control_step`, the JAX package's vmapped engine):
    dense per-env matrices batched over the env axis — the 18 x 18 mass
    matrix (kinematics.py, dynamics.py) and the 3S x 3S Delassus matrix —
    with three contact models: the world-frame projected Jacobi solve
    (fastpath.py, its sweeps in K1), projected Gauss-Seidel and Jacobi in
    contact frames (contact.py, `fast=False`), and soft penalty contacts.

The per-env terrain window is gathered once per control step by kernel K2
(kernels/terrain_window.py) on both paths.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from agility_tpu_torch import trace
from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.kernels.terrain_window import terrain_window
from agility_tpu_torch.physics import contact as ct
from agility_tpu_torch.physics import dynamics as dyn
from agility_tpu_torch.physics import fastpath as fp
from agility_tpu_torch.physics import kinematics as kin
from agility_tpu_torch.physics import soa
from agility_tpu_torch.physics.constants import ModelConsts
from agility_tpu_torch.physics.kinematics import ix


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 1.0 / 200.0          # sim dt
    decimation: int = 4              # control dt = dt * decimation
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    solver: str = "jacobi"           # "jacobi" | "pgs" | "soft"
    pgs_iters: int = 4               # Gauss-Seidel sweeps (fast=False, solver="pgs")
    jacobi_iters: int = 10
    jacobi_relax: float = 0.6
    warm_start: bool = False         # carry contact impulses across substeps (SoA path)
    baumgarte: float = 0.2
    contact_slop: float = 0.002
    max_depenetration_vel: float = 1.0
    restitution: float = 0.0
    # soft-contact gains (solver="soft")
    soft_kn: float = 5000.0
    soft_cn: float = 150.0
    soft_kt: float = 500.0
    enforce_joint_limits: bool = True
    fast: bool = True                # per-env path: world-frame dynamics and contact
    #                                  (fastpath.py); False: contact frames (contact.py)
    patch_size: int = 24             # per-env terrain window per control step;
    #                                  0: direct grid queries (per-env path)
    pallas_contact: bool = False     # per-env path with the world-frame Jacobi solve
    #                                  whatever `solver` and `fast` say (the JAX
    #                                  package's fused-kernel route)
    pallas_env_block: int = 16       # unused: kept for parity with the JAX config
    #                                  (K1 picks its own launch configuration)
    soa: bool = True                 # the SoA path (where solver and pallas_contact allow)


class EnvParams(NamedTuple):
    """Per-env domain-randomized physical parameters (leading env axis)."""
    friction: torch.Tensor          # (N,)
    kp_scale: torch.Tensor          # (N, nu)
    kd_scale: torch.Tensor          # (N, nu)
    added_base_mass: torch.Tensor   # (N,)
    base_com_shift: torch.Tensor    # (N, 3)
    hf_weights: torch.Tensor = None  # (N, L) movable-layer weights + seesaw tilt, or None

    @staticmethod
    def nominal(num_envs: int, nu: int = 12, dtype=torch.float32,
                device="cuda") -> "EnvParams":
        """Unit friction and gains, no payload, no CoM shift."""
        o = lambda *s: torch.ones((num_envs,) + s, dtype=dtype, device=device)
        z = lambda *s: torch.zeros((num_envs,) + s, dtype=dtype, device=device)
        return EnvParams(friction=o(), kp_scale=o(nu), kd_scale=o(nu), added_base_mass=z(),
                         base_com_shift=z(3))


class Control(NamedTuple):
    """PD position targets + gains (N, nu)."""
    target: torch.Tensor
    kp: torch.Tensor
    kd: torch.Tensor


class EnvState(NamedTuple):
    """Generalized state carried between substeps (leading env axis)."""
    base_pos: torch.Tensor   # (N, 3)
    base_quat: torch.Tensor  # (N, 4) xyzw
    dof_pos: torch.Tensor    # (N, nu)
    u: torch.Tensor          # (N, 6 + nu) [v_base, w_base, qd]


def _env_consts(mc: ModelConsts, params: EnvParams) -> ModelConsts:
    """The model with each env's payload and CoM shift on the base link:
    link_mass (N, L), link_com (N, L, 3)."""
    N, L = params.friction.shape[0], mc.n_links
    mass = mc.link_mass.expand(N, L).clone()
    mass[:, 0] += params.added_base_mass
    com = mc.link_com.expand(N, L, 3).clone()
    com[:, 0] += params.base_com_shift
    return dataclasses.replace(mc, link_mass=mass, link_com=com)


def pd_torques(mc: ModelConsts, control: Control, params: EnvParams, dof_pos, dof_vel):
    """Scaled PD with the per-env motor-strength factors, clipped to the
    effort limits.  Returns (clipped, unclipped)."""
    tau = (params.kp_scale * control.kp * (control.target - dof_pos)
           - params.kd_scale * control.kd * dof_vel)
    lim = mc.dof_effort_limit
    return torch.minimum(torch.maximum(tau, -lim), lim), tau


class PreContact(NamedTuple):
    """A fast-path substep up to the contact solve."""
    u_free: torch.Tensor     # (N, nv) velocity after dt without contact
    phi: torch.Tensor        # (N, S')
    normals: torch.Tensor    # (N, S', 3)
    JpT: torch.Tensor        # (N, nv, 3S')
    factors: dyn.MassFactors
    tau: torch.Tensor        # (N, nv) generalized actuation [0 (6), tau_j]
    C: torch.Tensor          # (N, nv) bias forces
    taus: tuple              # (tau_j, tau_org) (N, nu)


def _kinematics(mce: ModelConsts, s: EnvState):
    ls = kin.fk(mce, s.base_pos, s.base_quat, s.dof_pos)
    ls = kin.velocities(mce, ls, s.u[:, :3], s.u[:, 3:6], s.u[:, 6:])
    return ls, kin.world_axes(mce, ls)


def _actuation(mce: ModelConsts, control: Control, params: EnvParams, s: EnvState):
    tau_j, tau_org = pd_torques(mce, control, params, s.dof_pos, s.u[:, 6:])
    return torch.cat([torch.zeros_like(s.u[:, :6]), tau_j], dim=1), (tau_j, tau_org)


def _pre_contact(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState, control: Control,
                 params: EnvParams, terrain_patch) -> PreContact:
    """The fast path up to (and excluding) the contact solve."""
    mce = _env_consts(mc, params)
    ls, axes = _kinematics(mce, s)
    tau, taus = _actuation(mce, control, params, s)
    M, C = fp.mass_and_bias(mce, ls, axes, s.u[:, 6:], cfg.gravity)
    factors = dyn.factor_mass_matrix(M)
    phi, normals, JpT = fp.detect_T(mce, ls, axes, grid, params.hf_weights, terrain_patch)
    u_free = s.u + cfg.dt * dyn.solve_mass(factors, tau - C)
    return PreContact(u_free, phi, normals, JpT, factors, tau, C, taus)


def substep(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState, control: Control,
            params: EnvParams, terrain_patch=None):
    """One physics substep of the per-env path.  Returns (new_state,
    (tau_j, tau_org), sphere_forces (N, S', 3))."""
    soft = dict(kn=cfg.soft_kn, cn=cfg.soft_cn, kt=cfg.soft_kt)
    if cfg.fast:
        p = _pre_contact(mc, cfg, grid, s, control, params, terrain_patch)
        factors, taus = p.factors, p.taus
        if cfg.solver in ("pgs", "jacobi"):
            u_new, sph_force = fp.jacobi_solve_world(
                p.phi, p.normals, p.JpT, factors, p.u_free, params.friction, cfg.dt,
                iters=cfg.jacobi_iters, relax=cfg.jacobi_relax, **soa.contact_kwargs(cfg))
        else:
            sph_force = fp.soft_forces_world(p.phi, p.normals, p.JpT, s.u, params.friction,
                                             **soft)
            tau_c = (p.JpT @ sph_force.reshape(s.u.shape[0], -1, 1))[..., 0]
            u_new = s.u + cfg.dt * dyn.solve_mass(factors, p.tau + tau_c - p.C)
    else:
        mce = _env_consts(mc, params)
        ls, axes = _kinematics(mce, s)
        tau, taus = _actuation(mce, control, params, s)
        M = dyn.mass_matrix(mce, ls, axes)
        C = dyn.bias_forces(mce, ls, axes, s.u[:, 6:], cfg.gravity)
        factors = dyn.factor_mass_matrix(M)
        con = ct.detect(mce, ls, axes, grid, params.hf_weights)
        if cfg.solver in ("pgs", "jacobi"):
            u_free = s.u + cfg.dt * dyn.solve_mass(factors, tau - C)
            if cfg.solver == "pgs":
                u_new, _, sph_force = ct.pgs_solve(con, factors, u_free, params.friction, cfg.dt,
                                                   iters=cfg.pgs_iters, **soa.contact_kwargs(cfg))
            else:
                u_new, _, sph_force = ct.jacobi_solve(
                    con, factors, u_free, params.friction, cfg.dt, iters=cfg.jacobi_iters,
                    relax=cfg.jacobi_relax, **soa.contact_kwargs(cfg))
        else:
            sph_force = ct.soft_forces(con, s.u, params.friction, **soft)
            # world contact forces into generalized coordinates: tau_c = Jp^T f
            Jp = torch.einsum("nsba,nsbv->nsav", con.frame, con.Jc)    # undo the frame rotation
            tau_c = torch.einsum("nsav,nsa->nv", Jp, sph_force)
            u_new = s.u + cfg.dt * dyn.solve_mass(factors, tau + tau_c - C)
    return _integrate(mc, cfg, s, u_new, factors), taus, sph_force


def _body_ids(mc: ModelConsts, n_rows: int, device):
    """Reported body of each contact row; ceiling rows (appended past S by
    fastpath.detect_T) accumulate onto the same leading base-link bodies."""
    ids = ix(mc.sph_body, device)
    return torch.cat([ids, ids[:n_rows - ids.shape[0]]]) if n_rows > ids.shape[0] else ids


def control_step(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState, control: Control,
                 params: EnvParams):
    """`decimation` substeps of the per-env path.  Returns (state, (tau,
    tau_org), body_forces (N, B, 3), max_body_forces (N, B, 3),
    terrain_patch): the window around each robot is gathered once here
    (K2) and read by every substep (the base moves a few cm within one
    control step)."""
    terrain_patch = None
    if cfg.fast and cfg.patch_size:
        terrain_patch = terrain_window(grid, s.base_pos[:, :2].contiguous(), cfg.patch_size,
                                       params.hf_weights)
    N = s.base_pos.shape[0]
    bf_all = []
    for _ in range(cfg.decimation):
        s, taus, sphf = substep(mc, cfg, grid, s, control, params, terrain_patch)
        bf = torch.zeros((N, mc.n_bodies, 3), dtype=sphf.dtype, device=sphf.device)
        bf_all.append(bf.index_add_(1, _body_ids(mc, sphf.shape[1], sphf.device), sphf))
    max_body_forces = torch.stack(bf_all).abs().amax(dim=0)
    return s, taus, bf_all[-1], max_body_forces, terrain_patch


def _clamp_base_velocity(u, max_lin=100.0, max_ang=50.0):
    """Backstop against runaway states (PhysX's max linear / angular velocity caps)."""
    return torch.cat([torch.clamp(u[:, :3], -max_lin, max_lin),
                      torch.clamp(u[:, 3:6], -max_ang, max_ang), u[:, 6:]], dim=1)


def _integrate(mc: ModelConsts, cfg: EngineConfig, s: EnvState, u_new, factors=None):
    """Base-velocity backstop, momentum-consistent limit impulses, then
    semi-implicit Euler and the residual joint clamp, which zeroes qd where
    it moved a joint."""
    u_new = _clamp_base_velocity(u_new)
    if cfg.enforce_joint_limits and factors is not None:
        u_new = dyn.limit_impulses(mc, factors, u_new, s.dof_pos, cfg.dt)
    base_pos = s.base_pos + cfg.dt * u_new[:, :3]
    base_quat = qm.quat_integrate(s.base_quat, u_new[:, 3:6], cfg.dt)
    dof_pos = s.dof_pos + cfg.dt * u_new[:, 6:]
    qd = u_new[:, 6:]
    if cfg.enforce_joint_limits:
        clamped = torch.minimum(torch.maximum(dof_pos, mc.dof_limit_lower), mc.dof_limit_upper)
        qd = torch.where(clamped == dof_pos, qd, 0.0)
        dof_pos = clamped
        lim = mc.dof_velocity_limit
        qd = torch.minimum(torch.maximum(qd, -lim), lim)
    return EnvState(base_pos, base_quat, dof_pos, torch.cat([u_new[:, :6], qd], dim=1))


def uses_soa(cfg: EngineConfig, grid) -> bool:
    """Whether `step_batch` takes the SoA path: iff `soa` is set, the solver
    is "jacobi" and `pallas_contact` is off; and always on a grid with a
    ceiling unless the per-env path can see it (the fast path with a window:
    fastpath.detect_T's ceiling rows)."""
    if grid.ceiling is not None and (cfg.pallas_contact or not cfg.fast or not cfg.patch_size):
        return True
    return cfg.soa and cfg.solver == "jacobi" and not cfg.pallas_contact


@trace.spanned("engine")
def step_batch(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState, control: Control,
               params: EnvParams):
    """The batched control-step entry point used by the env layer: the SoA
    path or the per-env path, as `uses_soa` says.  Returns (state, (tau,
    tau_org), body_forces, max_body_forces, terrain_patch).

    Only the SoA path carries impulses across substeps, so on the per-env
    path a warm-start config runs 2 x jacobi_iters cold sweeps (the warm 5
    sweeps reach the cold 10-sweep fixed point).

    The JAX package also reads the AGILITY_ENGINE environment variable here,
    a workaround for XLA-CPU compile times that its tests/conftest.py sets
    to "vmap" for the whole pytest process; the port does not read it (it
    would move every port test off the SoA path): a caller picks the per-env
    path with EngineConfig(soa=False) or a solver other than "jacobi"."""
    if uses_soa(cfg, grid):
        return soa.control_step_batched(mc, cfg, grid, s, control, params)
    if cfg.warm_start:
        cfg = dataclasses.replace(cfg, warm_start=False, jacobi_iters=2 * cfg.jacobi_iters)
    return control_step_batched(mc, cfg, grid, s, control, params)


def control_step_batched(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState,
                         control: Control, params: EnvParams):
    """The per-env control step.  With `pallas_contact` it is the fast path
    with the world-frame Jacobi solve whatever `solver` and `fast` say (the
    window only where `fast` and `patch_size` are set), as the JAX package's
    fused-kernel route; on CUDA tensors the sweeps run in K1 either way."""
    if cfg.pallas_contact:
        cfg = dataclasses.replace(cfg, fast=True, solver="jacobi",
                                  patch_size=cfg.patch_size if cfg.fast else 0)
    return control_step(mc, cfg, grid, s, control, params)


def refresh_sim_state(mc: ModelConsts, s: EnvState):
    """Reported body states (N, B, ...) after a control step: pos, quat,
    vel, omega."""
    ls = kin.fk(mc, s.base_pos, s.base_quat, s.dof_pos)
    ls = kin.velocities(mc, ls, s.u[:, :3], s.u[:, 3:6], s.u[:, 6:])
    return kin.body_states(mc, ls)
