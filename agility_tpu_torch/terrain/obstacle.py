"""Obstacle-course helpers the env evaluates every step (counterpart of the
device half of agility_tpu/terrain/obstacle.py).

The course world itself is built on the host by the JAX package's numpy
generator (`agility_tpu.terrain.obstacle.generate`, which imports no jax),
re-exported here with its config and constants; only `lever_arm`, which the
JAX package writes in jax.numpy, is ported.
"""
from __future__ import annotations

import torch

from agility_tpu.terrain.obstacle import (  # noqa: F401  (re-exported)
    OBST_TYPES, SEESAW_HALF_LEN, SEESAW_THETA_MAX, SEESAW_WIDTH, ObstacleCfg, generate)


def lever_arm(seesaw_pose, x, y):
    """Analytic signed seesaw lever arm [m] at world (x, y): the signed
    along-plank offset where (x, y) lies on the surviving plank, else 0.

    seesaw_pose: (..., 5) [pivot_x, pivot_y, yaw, t_lo, t_hi]; x/y
    broadcastable against seesaw_pose[..., 0]."""
    px, py, yaw = seesaw_pose[..., 0], seesaw_pose[..., 1], seesaw_pose[..., 2]
    t_lo, t_hi = seesaw_pose[..., 3], seesaw_pose[..., 4]
    c, s = torch.cos(yaw), torch.sin(yaw)
    dx, dy = x - px, y - py
    along = c * dx + s * dy
    perp = -s * dx + c * dy
    on = ((along >= t_lo) & (along <= t_hi)
          & (torch.abs(along) <= SEESAW_HALF_LEN)
          & (torch.abs(perp) <= SEESAW_WIDTH / 2))
    return torch.where(on, along, 0.0)
