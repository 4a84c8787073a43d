"""`device_idle.distill`: see benchmark/harness/readers.py:device_idle."""
from benchmark.harness.readers import device_idle as read  # noqa: F401
