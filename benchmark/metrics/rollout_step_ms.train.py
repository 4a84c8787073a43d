"""`rollout_step_ms.train`: see benchmark/harness/readers.py:rollout_step_ms."""
from benchmark.harness.readers import rollout_step_ms as read  # noqa: F401
