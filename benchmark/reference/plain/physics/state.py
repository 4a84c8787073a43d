"""Simulation state of a batch of envs (counterpart of agility_tpu/physics/state.py).

The reference's gymtorch tensor views in one NamedTuple: root states,
dof states, rigid-body states and net contact forces.  Every field has a
leading env axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SimState(NamedTuple):
    # generalized coordinates
    base_pos: torch.Tensor        # (N, 3)
    base_quat: torch.Tensor       # (N, 4) xyzw
    dof_pos: torch.Tensor         # (N, nu)
    # generalized velocity (world-frame base twist)
    base_lin_vel: torch.Tensor    # (N, 3)
    base_ang_vel: torch.Tensor    # (N, 3)
    dof_vel: torch.Tensor         # (N, nu)
    # outputs refreshed by the engine after every control step
    body_pos: torch.Tensor        # (N, B, 3)
    body_quat: torch.Tensor       # (N, B, 4)
    body_vel: torch.Tensor        # (N, B, 3)
    body_ang_vel: torch.Tensor    # (N, B, 3)
    contact_forces: torch.Tensor  # (N, B, 3) net contact force per body [N]
    torques: torch.Tensor         # (N, nu) last applied joint torques

    @property
    def root_states(self) -> torch.Tensor:
        """(N, 13) root state [pos, quat, lin vel, ang vel] in Isaac's layout."""
        return torch.cat([self.base_pos, self.base_quat, self.base_lin_vel,
                          self.base_ang_vel], dim=-1)


def zero_state(n_envs: int, nu: int, n_bodies: int, dtype=torch.float32,
               device="cuda") -> SimState:
    """All zeros, with identity quaternions."""
    z = lambda *s: torch.zeros((n_envs,) + s, dtype=dtype, device=device)
    quat, bquat = z(4), z(n_bodies, 4)
    quat[:, 3] = 1.0
    bquat[:, :, 3] = 1.0
    return SimState(base_pos=z(3), base_quat=quat, dof_pos=z(nu), base_lin_vel=z(3),
                    base_ang_vel=z(3), dof_vel=z(nu), body_pos=z(n_bodies, 3),
                    body_quat=bquat, body_vel=z(n_bodies, 3), body_ang_vel=z(n_bodies, 3),
                    contact_forces=z(n_bodies, 3), torques=z(nu))
