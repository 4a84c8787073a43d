"""`engine_ms.distill`: see benchmark/harness/readers.py:engine_ms."""
from benchmark.harness.readers import engine_ms as read  # noqa: F401
