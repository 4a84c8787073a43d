"""Deployment export of trained policies (counterpart of
agility_tpu/io/export.py).

The reference exports policies as TorchScript for on-robot inference
(export_policy_as_jit, bbc/legged_gym/utils/helpers.py:233-271); the JAX
package serialises its jitted policy as a StableHLO artifact.  Here
`export_policy` traces the policy module with `torch.export` at the
example inputs' shapes into a `.pt2` program that `load_policy` (or any
process with torch, no import of this package needed) runs; and
`export_params_npz` writes a plain-numpy `.npz` of a flax-layout parameter
tree (`io/checkpoint.params_to_jax` / `params_to_jax_tsc`) under the keys
the JAX package's `export_params_npz` gives the same tree, so that a
non-torch runtime reads the same file from either package.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Sequence

import numpy as np
import torch


def export_policy(policy: torch.nn.Module, example_inputs: Sequence[torch.Tensor],
                  out_path: str) -> str:
    """Serialise `policy` traced at the example inputs' shapes, dtypes and
    device to `<out_path>.pt2`; returns the path."""
    program = torch.export.export(policy, tuple(example_inputs))
    path = out_path if out_path.endswith(".pt2") else out_path + ".pt2"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_policy(path: str) -> Callable:
    """The exported program of `path` as a callable module."""
    return torch.export.load(path).module()


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Leaves of a nested dict under jax.tree_util.keystr's keys
    ("['a']['b']"), in its order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}[{k!r}]", out)
    else:
        out[prefix] = (tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                       else np.asarray(tree))


def export_params_npz(params, out_path: str) -> str:
    """Flat numpy dump of a nested dict of parameters (numpy arrays or
    tensors) to `<out_path>.npz`, keyed by each leaf's path; returns the
    path."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    path = out_path if out_path.endswith(".npz") else out_path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    return path
