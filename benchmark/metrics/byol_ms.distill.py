"""`byol_ms.distill`: see benchmark/harness/distill_readers.py:byol_ms."""
from benchmark.harness.distill_readers import byol_ms as read  # noqa: F401
