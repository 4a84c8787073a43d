"""Pieces both traffic kinds share: the program's CLI module by name, output
of the program kept off standard output, tensors to the host, sampled
positions from the seed, and the profiled slice's readings."""
from __future__ import annotations

import contextlib
import importlib
import os
import resource
import shutil
import subprocess
import sys
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def cli_module(name: str):
    """The program's CLI module `agility_tpu_torch.cli.<name>`."""
    return importlib.import_module(f"agility_tpu_torch.cli.{name}")


@contextlib.contextmanager
def quiet():
    """The program's prints go to standard error: the last line of standard
    output is the result."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def to_device(x, device):
    """Tensors (in dicts, lists and NamedTuples) copied to `device`."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


def host(x):
    return to_device(x, "cpu")


def clone_state(x):
    """A NamedTuple of tensors (nested) with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    return x


def sample_positions(seed: int, salt: int, k: int, ranges: Iterable[int]) -> List[Tuple]:
    """`k` distinct positions (tuples of indices into `ranges`), drawn from
    the seed."""
    ranges = list(ranges)
    rng = np.random.default_rng([seed, salt])
    total = int(np.prod(ranges))
    flat = rng.choice(total, size=min(k, total), replace=False)
    return sorted(tuple(int(i) for i in np.unravel_index(f, ranges)) for f in flat)


def slice_readings(sl, steps: int, k1_shapes: List[Tuple[int, int]]) -> Dict:
    """What the per-layer readers take from a profiled slice covering `steps`
    control steps."""
    from benchmark.harness import trace as tr

    k1 = [d for name, _, d in sl.device if tr.K1_KERNEL in name]
    return dict(wall_s=sl.wall_s, busy_s=sl.busy_s(), device_ops=len(sl.device),
                steps=steps, k1_s=k1, k1_shape=k1_shapes[0] if k1_shapes else None,
                breakdown=sl.breakdown())


GPU_QUERY = ("clocks.sm,clocks.mem,clocks.max.sm,power.draw,power.limit,temperature.gpu,"
             "clocks_throttle_reasons.active")


def gpu_reading() -> Dict:
    """The card's clocks, power, temperature and throttle reasons from
    nvidia-smi, or nothing where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {}
    try:
        out = subprocess.run([smi, f"--query-gpu={GPU_QUERY}", "--format=csv,noheader,nounits",
                              "--id=0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(GPU_QUERY.split(","), vals)) if out.returncode == 0 else {}


def launch_probe_us(device, n: int = 2000) -> float:
    """Microseconds per tiny eager op launched on the device and synchronised:
    the host's launch speed, which paces every cell."""
    x = torch.zeros(1, device=device)
    sync(device)
    t = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
    sync(device)
    return 1e6 * (time.perf_counter() - t) / n


class HostWatch:
    """What may differ between two processes of one cell, read just before
    and just after the window, outside its time: the CPUs the process may
    run on, the load average, the card's clocks and power, the host's launch
    speed, and the process's CPU time and context switches over the window."""

    def __init__(self, device):
        self.device = device

    def _probes(self) -> Dict:
        return dict(load=os.getloadavg(), gpu=gpu_reading(),
                    launch_us=launch_probe_us(self.device))

    @staticmethod
    def _counters() -> Dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return dict(wall=time.perf_counter(), cpu=ru.ru_utime + ru.ru_stime,
                    nivcsw=ru.ru_nivcsw, nvcsw=ru.ru_nvcsw)

    def begin(self) -> None:
        """The probes, then the counters: the probes stay outside the span."""
        self._a = self._probes()
        self._a.update(self._counters())

    def end(self) -> Dict:
        b = self._counters()
        b.update(self._probes())
        a = self._a
        wall = b["wall"] - a["wall"]
        return dict(cpus=sorted(os.sched_getaffinity(0)), load=[a["load"], b["load"]],
                    gpu=[a["gpu"], b["gpu"]], launch_us=[a["launch_us"], b["launch_us"]],
                    cpu_share=(b["cpu"] - a["cpu"]) / max(wall, 1e-9),
                    involuntary_switches=b["nivcsw"] - a["nivcsw"],
                    voluntary_switches=b["nvcsw"] - a["nvcsw"])
