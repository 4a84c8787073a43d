"""K2, the per-env terrain window, in plain torch on every device: the port's
plain twin of its CUDA kernel (agility_tpu_torch/kernels/terrain_window.py)
is patch.extract_batch, frozen here with the physics."""
from __future__ import annotations

from benchmark.reference.plain.physics.patch import extract_batch as terrain_window  # noqa: F401
