"""Benchmark: BBC and TSC-teacher training throughput on one CUDA card
(counterpart of the repository's root bench.py, which times the JAX package).

    python -m agility_tpu_torch.bench                  # one CUDA card
    BENCH_ENVS=8 BENCH_TSC_ENVS=8 BENCH_ITERS=1 BENCH_FAST=1 \\
        python -m agility_tpu_torch.bench --device cpu  # a tiny run on the CPU

Prints one JSON line per stack (BBC first):
  {"metric": "env_steps_per_sec", "value": N, "unit": "env-steps/s",
   "device": "<name>, <power limit>", "iter_ms": [...]}
  {"metric": "tsc_env_steps_per_sec", ...}

`value` is full training-iteration throughput (rollout, GAE, PPO, the
discriminator update, DAgger where due): the timed iterations' env-steps
over their mean host-clock time, synchronised before the clock starts and
after the last iteration.  `iter_ms` gives each timed iteration's time
from CUDA events recorded between iterations (no host sync inside the
timed loop; the host clock on the CPU).  `device` is what `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints for the card
("cpu" on the CPU).  stderr carries heartbeats.

On a terminal error (no card without --device cpu included) it prints,
for each line not yet printed, a well-formed line with value 0 and an
"error" field, and exits 1.

Env knobs (the root bench's, with its defaults):
  BENCH_ENVS      (default 4096)  BBC env count
  BENCH_TSC_ENVS  (default 6144)  TSC env count (64 courses)
  BENCH_ITERS     (default 5)     timed iterations, after one warm one
  BENCH_TSC       (default 1)     0 = skip the TSC line
  BENCH_FAST      (default 0)     1 = a 4096-transition expert preload
                                  (setup only; the timed iteration is the same)
  BENCH_COLD      (default 0)     1 = no contact warm start, 10 cold Jacobi
                                  sweeps (BBC)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import List, Optional, Tuple

import torch

from agility_tpu_torch.envs.config import EnvCfg, Go2LocomotionCfg, SimCfg, TerrainCfg
from agility_tpu_torch.envs.tsc_config import Go2AgilityCfg
from agility_tpu_torch.learn.ssinfogail import AlgoCfg

METRICS = ("env_steps_per_sec", "tsc_env_steps_per_sec")
_T0 = time.time()


def _beat(msg):
    sys.stderr.write(f"[bench +{time.time() - _T0:7.1f}s] {msg}\n")
    sys.stderr.flush()


def _fail_json(err, metrics=METRICS):
    """Terminal failure: still emit a well-formed line for each of `metrics`."""
    for metric in metrics:
        print(json.dumps({"metric": metric, "value": 0.0, "unit": "env-steps/s",
                          "error": str(err)[:500]}), flush=True)


def bbc_config(num_envs: int, cold: bool = False) -> Go2LocomotionCfg:
    """The full BBC configuration (rough terrain, domain randomisation, mocap
    init) on the root bench's 4 x 4 terrain with a 10 m border
    (bench.py:110-126); `cold`: no warm start, 10 Jacobi sweeps."""
    cfg = Go2LocomotionCfg(env=EnvCfg(num_envs=num_envs),
                           terrain=TerrainCfg(num_rows=4, num_cols=4, border_size=10.0))
    if cold:
        cfg = dataclasses.replace(cfg, sim=SimCfg(warm_start=False, jacobi_iters=10))
    return cfg


def bbc_algo_cfg(num_envs: int, fast: bool = False) -> AlgoCfg:
    """The root bench's AlgoCfg (bench.py:130-132): the expert preload (4096
    under BENCH_FAST) and a replay ring of whole rollout steps."""
    return AlgoCfg(num_preload_transitions=4096 if fast else 50_000,
                   disc_replay_buffer_size=(500_000 // num_envs) * num_envs)


def tsc_config(num_envs: int) -> Go2AgilityCfg:
    """The TSC task's config at `num_envs` envs (bench.py:185-186)."""
    cfg = Go2AgilityCfg()
    return dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs))


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu" on
    the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_iterations(alg, ts, es, disc_hist, iters: int,
                    profile: Optional[str] = None) -> Tuple[float, List[float]]:
    """One warm train iteration at it = 1, then `iters` timed ones at it =
    i + 2 (the root bench's indices: they decide DAgger, it %
    dagger_update_freq).  Returns (mean seconds a timed iteration on the
    host clock, synchronised at both ends; each timed iteration's ms).
    With `profile` (a path) the timed iterations run under torch.profiler,
    whose chrome trace is written there: the device's activity on the card
    (a step issues ~63k kernels; the host's operators would double the
    trace), the host's operators on the CPU."""
    device = alg.device
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def stamp():
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    t0 = time.perf_counter()
    ts, es, disc_hist, _ = alg.train_iteration(ts, es, disc_hist, 1)
    sync()
    _beat(f"first iteration done ({time.perf_counter() - t0:.1f}s); measuring {iters} iters")
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity

        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    with prof:
        t0 = time.perf_counter()
        stamps = [stamp()]
        for i in range(iters):
            ts, es, disc_hist, _ = alg.train_iteration(ts, es, disc_hist, i + 2)
            stamps.append(stamp())
        sync()
        dt = (time.perf_counter() - t0) / iters
    if profile:
        prof.export_chrome_trace(profile)
        _beat(f"trace written to {profile}")
    iter_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return dt, iter_ms


def line(metric: str, steps_per_iter: int, dt: float, device: torch.device,
         iter_ms: List[float]) -> dict:
    rate = steps_per_iter / dt
    return {"metric": metric, "value": round(rate, 1), "unit": "env-steps/s",
            "device": device_label(device), "iter_ms": [round(t, 3) for t in iter_ms]}


def bench_bbc(device="cuda", num_envs: int = 4096, iters: int = 5, fast: bool = False,
              cold: bool = False, cfg: Optional[Go2LocomotionCfg] = None
              ) -> Tuple[dict, float]:
    """The BBC training line (bench.py:103-166) on synthetic clips; `cfg`
    replaces bbc_config(num_envs, cold).  Returns (the line, mean seconds a
    timed iteration)."""
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.ssinfogail import SSInfoGAIL

    device = torch.device(device)
    cfg = cfg or bbc_config(num_envs, cold)
    env = Go2LocomotionEnv(cfg, device, seed=1)
    _beat("env built")
    algo_cfg = bbc_algo_cfg(cfg.env.num_envs, fast)
    alg = SSInfoGAIL(env, algo_cfg, seed=0)
    _beat("alg built (expert transitions preloaded)")
    ts = alg.init_train_state()
    es = env.init_state()
    dh = es.disc_obs[:, None].repeat(1, cfg.env.disc_obs_len, 1)
    _beat("states initialized")
    dt, iter_ms = time_iterations(alg, ts, es, dh, iters)
    out = line("env_steps_per_sec", algo_cfg.num_steps_per_env * cfg.env.num_envs, dt, device,
               iter_ms)
    _beat(f"measured {dt * 1e3:.1f} ms/iter")
    return out, dt


def bench_tsc(device="cuda", num_envs: int = 6144, iters: int = 5,
              cfg: Optional[Go2AgilityCfg] = None, algo_cfg=None,
              profile: Optional[str] = None) -> Tuple[dict, float]:
    """The TSC teacher's training line (bench.py:169-216): the TSC policy,
    set_commands, a fresh frozen BBC (drawn by torch from seed 0: not the
    JAX package's weights), the obstacle-course env and the hybrid PPO
    update; `cfg` replaces tsc_config(num_envs), `algo_cfg` TscAlgoCfg(),
    `profile` as time_iterations'.  Returns (the line, mean seconds a
    timed iteration)."""
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.io.checkpoint import load_bbc_frozen
    from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg, TscPPO

    device = torch.device(device)
    cfg = cfg or tsc_config(num_envs)
    env = Go2AgilityEnv(cfg, device, seed=1)
    alg = TscPPO(env, load_bbc_frozen(None, seed=0), algo_cfg or TscAlgoCfg())
    _beat("tsc env+alg built")
    ts = alg.init_train_state()
    es = env.init_state()
    dh = es.disc_obs[:, None].repeat(1, 2, 1)      # two frames, as bench.py:193
    _beat("tsc states initialized")
    dt, iter_ms = time_iterations(alg, ts, es, dh, iters, profile)
    _beat(f"tsc measured {dt * 1e3:.1f} ms/iter")
    return line("tsc_env_steps_per_sec", alg.cfg.num_steps_per_env * cfg.env.num_envs, dt,
                device, iter_ms), dt


def knobs(environ=os.environ) -> dict:
    """The BENCH_* environment variables, with the root bench's defaults."""
    get = lambda k, d: environ.get(k, d)
    return dict(envs=int(get("BENCH_ENVS", "4096")), tsc_envs=int(get("BENCH_TSC_ENVS", "6144")),
                iters=int(get("BENCH_ITERS", "5")), tsc=get("BENCH_TSC", "1") == "1",
                fast=get("BENCH_FAST", "0") == "1", cold=get("BENCH_COLD", "0") == "1")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    k = knobs()
    pending = list(METRICS if k["tsc"] else METRICS[:1])
    try:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _beat(f"torch {torch.__version__}, device {device_label(device)}")
        out, _ = bench_bbc(device, k["envs"], k["iters"], k["fast"], k["cold"])
        print(json.dumps(out), flush=True)
        pending.pop(0)
        if k["tsc"]:
            out, _ = bench_tsc(device, k["tsc_envs"], k["iters"])
            print(json.dumps(out), flush=True)
            pending.pop(0)
    except Exception as e:      # the bench's boundary: report, then fail
        traceback.print_exc()
        _fail_json(e, pending)
        sys.exit(1)


if __name__ == "__main__":
    main()
