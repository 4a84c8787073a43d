"""`render_ms.distill`: see benchmark/harness/distill_readers.py:render_ms."""
from benchmark.harness.distill_readers import render_ms as read  # noqa: F401
