"""Task registry: name -> (env-config factory, algo-config factory)
(counterpart of agility_tpu/cli/registry.py).

The TSC task is registered under the JAX registry's name, "go2", and the
port's earlier "go2_agility".  The JAX registry's 32k tasks
(go2_locomotion_32k, go2_32k) wait for training over several cards.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from agility_tpu_torch.envs import config as bbc_config
from agility_tpu_torch.envs import tsc_config
from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg
from agility_tpu_torch.learn.ssinfogail import AlgoCfg

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "go2_locomotion": (bbc_config.Go2LocomotionCfg, AlgoCfg),
    "go2_locomotion_smoke": (lambda: bbc_config.smoke_cfg(64), AlgoCfg),
    "go2": (tsc_config.Go2AgilityCfg, TscAlgoCfg),
    "go2_agility": (tsc_config.Go2AgilityCfg, TscAlgoCfg),
}


def get(name: str) -> Tuple[Callable, Callable]:
    """(make_env_cfg, make_algo_cfg) of task `name`."""
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
