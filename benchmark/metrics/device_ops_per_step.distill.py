"""`device_ops_per_step.distill`: see benchmark/harness/readers.py:device_ops_per_step."""
from benchmark.harness.readers import device_ops_per_step as read  # noqa: F401
