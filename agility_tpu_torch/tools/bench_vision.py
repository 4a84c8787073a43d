"""Depth-student training-iteration throughput (counterpart of the JAX
package's tools/bench_vision.py): the student iteration of
learn/vision_tsc.py (the depth ray-march every update_interval steps, the
GRU encoder, the student heads, set_commands, the frozen BBC, the env step;
then distillation and BYOL) on one card, with its peak device memory.

    python -m agility_tpu_torch.tools.bench_vision                  # BENCH_ENVS=1024, one card
    BENCH_ENVS=4 BENCH_ITERS=1 python -m agility_tpu_torch.tools.bench_vision --device cpu

The JAX tool's setup: Go2AgilityCfg() (64 courses) at BENCH_ENVS envs, a
fresh frozen BBC (load_bbc_frozen(None, seed=0): drawn by torch, not the
JAX package's weights), a fresh TSC teacher (TscPPO's initial weights) as
the student's start, VisionCfg(), seed 0; one warm iteration, then
BENCH_ITERS (5) timed ones on the synchronised host clock (rounds of
tools/timing.py).  Peak device memory is torch.cuda.max_memory_allocated
from the start of the warm iteration (not measured on the CPU).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from agility_tpu_torch.tools import timing


def build(device, N=1024, T=None, cfg=None):
    """(vision, [ts, es]): the student on the JAX tool's configuration
    (`cfg` replaces it); `T` replaces VisionCfg's 24 steps."""
    from agility_tpu_torch.bench import tsc_config
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.io.checkpoint import load_bbc_frozen
    from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg, TscPPO
    from agility_tpu_torch.learn.vision_tsc import TscVision, VisionCfg

    env = Go2AgilityEnv(cfg or tsc_config(N), device, seed=1)
    alg = TscPPO(env, load_bbc_frozen(None, seed=0), TscAlgoCfg())
    ts_t = alg.init_train_state()
    vcfg = VisionCfg() if T is None else dataclasses.replace(VisionCfg(), num_steps_per_env=T)
    vision = TscVision(env, ts_t.ac, ts_t.est, alg.bbc_ac, vcfg, seed=0)
    return vision, [vision.init_train_state(), env.init_state()]


def bench(device, N=1024, iters=5, T=None, cfg=None):
    """The iteration's row (timing.interleaved's: ms an iteration, launches,
    and env_steps_per_s, peak_bytes, finite metrics)."""
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    vision, state = build(device, N, T, cfg)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    last = {}

    def run():
        state[0], state[1], last["m"] = vision.train_iteration(*state)

    row, = timing.interleaved([timing.Variant("vision train_iteration", run)], device, iters)
    row["env_steps_per_s"] = vision.cfg.num_steps_per_env * N / (row["ms"] * 1e-3)
    row["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
    row["finite"] = all(map(math.isfinite, metrics_to_host(last["m"]).values()))
    return row


def main(argv=None):
    device, label = timing.open_device(argv, "vision student iteration throughput")
    N = int(os.environ.get("BENCH_ENVS", "1024"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    row = bench(device, N, iters)
    peak = "not measured" if row["peak_bytes"] is None else \
        f"{row['peak_bytes'] / 2**30:.3f} GiB"
    print(f"vision student: {row['ms']:.1f} ms/iter [{row['ms_min']:.1f}, {row['ms_max']:.1f}] "
          f"-> {row['env_steps_per_s']:,.0f} env-steps/s; peak device memory {peak} on {label}",
          flush=True)
    print(json.dumps({"device": label, "num_envs": N, "iters": iters, "row": row}))


if __name__ == "__main__":
    main()
