"""The batched simulation engine (counterpart of agility_tpu/physics/engine.py).

PD actuation -> forward dynamics -> contact solve -> semi-implicit
integration, `decimation` substeps per control step.  The port has one path,
the env-minor SoA substep (physics/soa.py) with the contact LCP in kernel K1;
the JAX package's vmapped oracle stays in JAX as the reference.  PD torques
(engine.pd_torques in JAX) are computed inside soa.substep, in env-minor
layout, as the JAX SoA path does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from agility_tpu_torch.physics import soa
from agility_tpu_torch.physics.constants import ModelConsts


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 1.0 / 200.0          # sim dt
    decimation: int = 4              # control dt = dt * decimation
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    jacobi_iters: int = 10
    jacobi_relax: float = 0.6
    warm_start: bool = False         # carry contact impulses across substeps
    baumgarte: float = 0.2
    contact_slop: float = 0.002
    max_depenetration_vel: float = 1.0
    restitution: float = 0.0
    enforce_joint_limits: bool = True
    patch_size: int = 24             # per-env terrain window per control step


class EnvParams(NamedTuple):
    """Per-env domain-randomized physical parameters (leading env axis)."""
    friction: torch.Tensor          # (N,)
    kp_scale: torch.Tensor          # (N, nu)
    kd_scale: torch.Tensor          # (N, nu)
    added_base_mass: torch.Tensor   # (N,)
    base_com_shift: torch.Tensor    # (N, 3)
    hf_weights: torch.Tensor = None  # (N, L) movable-layer weights + seesaw tilt, or None


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


def step_batch(mc: ModelConsts, cfg: EngineConfig, grid, s: EnvState,
               control: Control, params: EnvParams):
    """The batched control-step entry point used by the env layer: always the
    SoA path.  Returns (state, (tau, tau_org), body_forces, max_body_forces,
    terrain_patch)."""
    return soa.control_step_batched(mc, cfg, grid, s, control, params)
