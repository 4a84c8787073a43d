"""The benchmark of agility_tpu_torch, the PyTorch and CUDA port: one run of
one cell on the machine it is started on.

    python benchmark/run.py --workload bbc_train --seed 7 --seconds 50 --trace 0

Prints the result as one JSON object, the last line of standard output;
the numbers compared for `correct`, each beside its limit, are the last
lines of standard error.  Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for."""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, _ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
