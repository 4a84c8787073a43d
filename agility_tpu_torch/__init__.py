"""agility_tpu_torch — the PyTorch / CUDA port of `agility_tpu`.

Same layout and names as the JAX package (core, physics, envs, learn, io,
cli), so each module's counterpart is found by path.  The port imports
`torch` and never `jax`/`flax`, and nothing of `agility_tpu`: it keeps its
own copies of the jax-free config dataclasses (`envs/config.py`,
`envs/tsc_config.py`), the numpy terrain and course generators
(`terrain/generator.py`, `terrain/obstacle.py`) and the Go2 model asset
(`assets/go2_model.json`).

Hand-written GPU kernels live in `csrc/` (CUDA C++ for sm_90a) and are bound
in `kernels/`; each has a plain-torch version beside it that serves CPU
tensors and is the kernel's test oracle.
"""

__version__ = "0.1.0"
