"""`k1_roofline.train`: see benchmark/harness/readers.py:k1_roofline."""
from benchmark.harness.readers import k1_roofline as read  # noqa: F401
