"""Task registry, env-config half (counterpart of agility_tpu/cli/registry.py).

The JAX registry also returns the algorithm configs, which import jax; the
port has no trainer yet, and the policy widths are the network modules'
defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from agility_tpu_torch.envs import config as bbc_config
from agility_tpu_torch.envs import tsc_config

_REGISTRY: Dict[str, Callable] = {
    "go2_locomotion": bbc_config.Go2LocomotionCfg,
    "go2_locomotion_smoke": lambda: bbc_config.smoke_cfg(64),
    "go2_agility": tsc_config.Go2AgilityCfg,      # the TSC task ("go2" in the JAX registry)
}


def get(name: str) -> Callable:
    """The env-config builder of task `name`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def apply_overrides(cfg, **kv):
    """Dotted-key overrides onto the frozen config tree (None values skipped)."""
    def set_in(node, parts, val):
        if len(parts) == 1:
            return dataclasses.replace(node, **{parts[0]: val})
        return dataclasses.replace(
            node, **{parts[0]: set_in(getattr(node, parts[0]), parts[1:], val)})

    for key, val in kv.items():
        if val is not None:
            cfg = set_in(cfg, key.split("."), val)
    return cfg
