"""`mfu.distill`: see benchmark/harness/readers.py:mfu."""
from benchmark.harness.readers import mfu as read  # noqa: F401
