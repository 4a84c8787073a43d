"""Numerical-health checks for the engine (counterpart of
agility_tpu/physics/debug.py).

`state_health` and `speed_gate` summarise a batch of states;
`checked(fn)` and `assert_finite` take the place of the JAX package's
checkify wrapping: they raise at the first non-finite value, naming where
it is, and never patch it.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def state_health(sim) -> Dict[str, torch.Tensor]:
    """Per-batch health summary of an EnvState-like NamedTuple of (N, ...)
    tensors: count of non-finite envs, max speeds, depth of the lowest
    body.  Cheap enough to run every iteration."""
    finite = torch.ones(sim.base_pos.shape[0], dtype=torch.bool, device=sim.base_pos.device)
    for leaf in sim:
        finite &= torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
    return {
        "nonfinite_envs": torch.sum(~finite),
        "max_base_speed": torch.max(torch.linalg.vector_norm(sim.u[:, :3], dim=-1)),
        "max_ang_speed": torch.max(torch.linalg.vector_norm(sim.u[:, 3:6], dim=-1)),
        "min_base_z": torch.min(sim.base_pos[:, 2]),
        "max_dof_vel": torch.max(torch.abs(sim.u[:, 6:])),
    }


# Physical envelope for a torque-limited Go2 (15 kg, hip 23.7 / thigh 23.7 /
# calf 45 Nm, 30 rad/s dof velocity cap): real hardware tops out at ~3.7-5
# m/s.  A policy sustaining base speeds beyond this gate is exploiting the
# integrator or the contact model, not locomoting.
GO2_SPEED_GATE = 8.0


def speed_gate(sim, gate: float = GO2_SPEED_GATE) -> Dict[str, torch.Tensor]:
    """Exploit detector: fraction of envs whose base speed exceeds the
    physical ceiling, plus the max.  A non-zero fraction sustained over
    iterations means the policy found an energy leak."""
    speed = torch.linalg.vector_norm(sim.u[:, :3], dim=-1)
    return {
        "overspeed_frac": torch.mean((speed > gate).float()),
        "max_base_speed": torch.max(speed),
    }


def _first_nonfinite(x, path: str):
    """The path of the first floating tensor in `x` (nested NamedTuples,
    tuples, lists and dicts) with a non-finite element, or None."""
    if isinstance(x, torch.Tensor):
        return path if x.is_floating_point() and not bool(torch.isfinite(x).all()) else None
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        items = ((f".{k}", v) for k, v in zip(x._fields, x))
    elif isinstance(x, (tuple, list)):
        items = ((f"[{i}]", v) for i, v in enumerate(x))
    elif isinstance(x, dict):
        items = ((f"[{k!r}]", v) for k, v in x.items())
    else:
        return None
    for sub, v in items:
        found = _first_nonfinite(v, path + sub)
        if found is not None:
            return found
    return None


def checked(fn: Callable) -> Callable:
    """`fn` wrapped to raise FloatingPointError, naming the output's path
    (e.g. "[0].sim.u"), when any floating tensor it returns holds a
    non-finite value:

        state, out = physics_debug.checked(env.step)(state, actions)
    """
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        where = _first_nonfinite(out, "")
        if where is not None:
            raise FloatingPointError(
                f"non-finite value in the output{where} of {getattr(fn, '__qualname__', fn)}")
        return out
    return wrapper


def assert_finite(tag: str, *arrays) -> None:
    """Raise FloatingPointError naming `tag` and the array's position when
    one of `arrays` holds a non-finite value."""
    for i, a in enumerate(arrays):
        if not bool(torch.isfinite(a).all()):
            raise FloatingPointError(f"non-finite in {tag}[{i}]")
