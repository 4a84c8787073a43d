"""`update_ms.distill`: see benchmark/harness/distill_readers.py:update_ms."""
from benchmark.harness.distill_readers import update_ms as read  # noqa: F401
