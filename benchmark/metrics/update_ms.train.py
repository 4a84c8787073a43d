"""`update_ms.train`: see benchmark/harness/readers.py:update_ms."""
from benchmark.harness.readers import update_ms as read  # noqa: F401
