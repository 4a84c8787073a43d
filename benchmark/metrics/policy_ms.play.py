"""`policy_ms.play`: see benchmark/harness/readers.py:policy_ms."""
from benchmark.harness.readers import policy_ms as read  # noqa: F401
