"""Env-layer throughput: the whole env.step (physics, observations,
rewards, resets) on the bench's BBC configuration (counterpart of the JAX
package's tools/bench_env.py; tools/bench_engine.py times physics alone,
tools/bench_stages.py the trainer's stages).

    python -m agility_tpu_torch.tools.bench_env                     # BENCH_ENVS=4096, one card
    BENCH_ENVS=8 BENCH_STEPS=2 python -m agility_tpu_torch.tools.bench_env --device cpu

The JAX tool's setup: Go2LocomotionCfg at BENCH_ENVS envs on a 4 x 4
terrain with a 10 m border (agility_tpu_torch/bench.py:bbc_config), the
env's init_state, actions tanh(obs_buf[:, :12]) (state-dependent, so no
step can be skipped).  T = BENCH_STEPS (48) steps a round, the state
carried from round to round, after one untimed round; 5 rounds on the
synchronised host clock (tools/timing.py); then one step's device
operations (not measured on the CPU).  Prints ms a control step and
env-steps/s, and a JSON line.
"""
from __future__ import annotations

import json
import os

import torch

from agility_tpu_torch.tools import timing


def act(s):
    return torch.tanh(s.obs_buf[:, :12])


def bench(device, N=4096, T=48, rounds=timing.ROUNDS):
    """The env.step row (timing.interleaved's: ms and launches a step, ops
    of one step, env_steps_per_s, finite rewards)."""
    from agility_tpu_torch.bench import bbc_config
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv

    env = Go2LocomotionEnv(bbc_config(N), device, seed=1)
    st = {"s": env.init_state()}

    def run():
        s = st["s"]
        for _ in range(T):
            s, out = env.step(s, act(s))
        st["s"], st["rew"] = s, out.rew

    with torch.no_grad():
        variant = timing.Variant("env.step", run, per=T,
                                 ops=lambda: env.step(st["s"], act(st["s"])))
        row, = timing.interleaved([variant], device, rounds)
        timing.count_device_ops([row], [variant], device)
    row["env_steps_per_s"] = N / (row["ms"] * 1e-3)
    row["finite"] = bool(torch.isfinite(st["rew"]).all())
    return row


def main(argv=None):
    device, label = timing.open_device(argv, "env.step throughput")
    N = int(os.environ.get("BENCH_ENVS", "4096"))
    T = int(os.environ.get("BENCH_STEPS", "48"))
    row = bench(device, N, T)
    print(f"env.step: {row['ms']:.2f} ms/control-step [{row['ms_min']:.2f}, {row['ms_max']:.2f}] "
          f"@ {N} envs -> {row['env_steps_per_s']:,.0f} env-steps/s "
          f"(physics+obs+rewards+resets); {row['ops'] or 'not measured'} device ops a step",
          flush=True)
    print(json.dumps({"device": label, "num_envs": N, "T": T, "rounds": timing.ROUNDS,
                      "row": row}))


if __name__ == "__main__":
    main()
