"""K3, the scandot measurement, in plain torch on every device: the port's
plain twin of its CUDA kernel (agility_tpu_torch/kernels/scandots.py) is
patch.measure_scandots_batch, frozen here with the physics."""
from __future__ import annotations

from benchmark.reference.plain.physics.patch import measure_scandots_batch as scandots  # noqa: F401
