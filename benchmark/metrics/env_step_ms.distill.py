"""`env_step_ms.distill`: see benchmark/harness/distill_readers.py:env_step_ms."""
from benchmark.harness.distill_readers import env_step_ms as read  # noqa: F401
