"""TSC teacher training-iteration throughput, optionally profiled
(counterpart of the JAX package's tools/bench_tsc.py: the root bench's TSC
line plus BENCH_PROFILE).  A thin layer over agility_tpu_torch/bench.py's
bench_tsc: the TSC policy, set_commands, the frozen BBC, the
obstacle-course env (SoA engine with the ceiling and lever surfaces) and
the hybrid PPO update, one warm iteration then BENCH_ITERS timed ones.

    python -m agility_tpu_torch.tools.bench_tsc                     # BENCH_ENVS=6144, one card
    BENCH_PROFILE=chiprun_out/tsc_trace.json python -m agility_tpu_torch.tools.bench_tsc
    python -m agility_tpu_torch.tools.trace_agg chiprun_out/tsc_trace.json
    BENCH_ENVS=8 BENCH_ITERS=1 python -m agility_tpu_torch.tools.bench_tsc --device cpu

BENCH_PROFILE: a path; the timed iterations run under torch.profiler (the
device's activity on the card, the host's operators on the CPU) and its
chrome trace is written there (~1.6M kernels an iteration at 6144 envs:
profile one, BENCH_ITERS=1).  The profiler
slows the host, which issues every operation here, so a profiled run's
rate is not the bench's, and the printed line says it was profiled.
"""
from __future__ import annotations

import os

from agility_tpu_torch.tools import timing

BASELINE = 61000.0      # the reference's RTX 3090 TSC rate (BASELINE.md)


def main(argv=None):
    from agility_tpu_torch import bench

    device, label = timing.open_device(argv, "TSC teacher iteration throughput")
    N = int(os.environ.get("BENCH_ENVS", "6144"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    profile = os.environ.get("BENCH_PROFILE", "")
    out, dt = bench.bench_tsc(device, N, iters, profile=profile or None)
    rate = 24 * N / dt
    print(f"tsc teacher: {dt * 1e3:.1f} ms/iter -> {rate:,.0f} env-steps/s (vs 61k "
          f"3090-derived: {rate / BASELINE:.2f}x) on {label}"
          + (f"; profiled (torch.profiler, trace at {profile}): not the unprofiled rate"
             if profile else ""), flush=True)
    return out, dt


if __name__ == "__main__":
    main()
