"""Diagnostic tools over the port, each run with `python -m
agility_tpu_torch.tools.<name>` (counterparts of the JAX package's
tools/make_gait_bands.py, diagnose_gait.py and diagnose_tsc.py)."""
