"""Per-stage timing of the BBC training iteration (counterpart of the JAX
package's tools/bench_stages.py): the iteration split into its rollout
(physics, observations, policy, disc reward), PPO update, discriminator
update and DAgger, read through the trainer's `timer` hook
(learn/ssinfogail.py: SSInfoGAIL.timer, marked after each stage's work is
enqueued) with a CUDA event at every mark (tools/timing.StageTimer).

    python -m agility_tpu_torch.tools.bench_stages                  # BENCH_ENVS=4096, one card
    BENCH_ENVS=8 python -m agility_tpu_torch.tools.bench_stages --device cpu

The JAX tool's configuration: the bench's BBC config (4 x 4 terrain,
10 m border, agility_tpu_torch/bench.py:bbc_config) at BENCH_ENVS envs,
a 4096-transition expert preload and a ring of 500,000 // N * N rows,
seeds 0 (trainer) and 1 (env).  Each round is one train_iteration at it =
0, so that DAgger runs in it (the JAX tool times each stage in a lax.scan
of BENCH_SCAN repeats; here the stages of 5 interleaved rounds,
tools/timing.py, after one untimed iteration).  Rows:
  full train_iteration     the iteration without DAgger (start to the disc
                           update's mark), as the JAX tool's full row at it = 1
  rollout (24 steps)       the rollout stage
  ppo_update (5ep x 4mb)   the PPO stage
  disc_update (80 mb)      the discriminator stage
  dagger_update            the DAgger stage (due every 20th iteration)
  residual                 full - rollout - ppo - disc: the draws and GAE
plus "train_iteration, host clock", the whole round on the synchronised
host clock.  ms are CUDA-event times (the host clock on the CPU); the
JSON line has every round's.
"""
from __future__ import annotations

import dataclasses
import json
import os

from agility_tpu_torch.tools import timing

STAGES = ("full train_iteration", "rollout ({T} steps)", "ppo_update (5ep x 4mb)",
          "disc_update (80 mb)", "dagger_update", "residual")


def labels(T=24):
    return [s.format(T=T) for s in STAGES]


def build(device, N=4096, T=None):
    """(alg, [ts, es, disc window]) on the JAX tool's configuration; `T`
    replaces the rollout's 24 steps."""
    from agility_tpu_torch.bench import bbc_algo_cfg, bbc_config
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.ssinfogail import SSInfoGAIL

    cfg = bbc_config(N)
    algo = bbc_algo_cfg(N, fast=True)
    if T is not None:
        algo = dataclasses.replace(algo, num_steps_per_env=T)
    env = Go2LocomotionEnv(cfg, device, seed=1)
    alg = SSInfoGAIL(env, algo, seed=0)
    es = env.init_state()
    return alg, [alg.init_train_state(), es,
                 es.disc_obs[:, None].repeat(1, cfg.env.disc_obs_len, 1)]


def iteration_variant(alg, state, rows_of):
    """A timing.Variant: one train_iteration at it = 0 under a StageTimer,
    returning rows_of(its stages) as readings."""
    def run():
        timer = timing.StageTimer(alg.device)
        alg.timer = timer
        try:
            state[:3] = alg.train_iteration(*state, 0)[:3]
            timer("end")
        finally:
            alg.timer = None
        stages, = timer.iterations()
        return rows_of(stages)
    return timing.Variant("train_iteration, host clock", run)


def stage_rows(T):
    names = labels(T)

    def rows_of(st):
        full = sum(v for k, v in st.items() if k not in ("dagger", "end"))
        return {names[0]: full, names[1]: st["rollout"], names[2]: st["ppo"],
                names[3]: st["disc"], names[4]: st["dagger"],
                names[5]: full - st["rollout"] - st["ppo"] - st["disc"]}
    return rows_of


def bench(device, N=4096, T=None, rounds=timing.ROUNDS):
    """The rows, in STAGES' order, then the host clock's."""
    alg, state = build(device, N, T)
    T = alg.cfg.num_steps_per_env
    rows = timing.interleaved([iteration_variant(alg, state, stage_rows(T))], device, rounds)
    by = {r["label"]: r for r in rows}
    return [by[k] for k in labels(T)] + [rows[0]]


def main(argv=None):
    device, label = timing.open_device(argv, "BBC train-iteration stages")
    N = int(os.environ.get("BENCH_ENVS", "4096"))
    print(f"N={N} envs, {timing.ROUNDS} rounds, on {label}", flush=True)
    rows = bench(device, N)
    print(timing.table(rows, "iteration"), flush=True)
    full, roll = rows[0]["ms"], rows[1]["ms"]
    print(f"\nfull iteration: {full:.1f} ms -> {24 * N / full * 1e3:,.0f} env-steps/s; rollout "
          f"{100 * roll / full:.1f}% [{roll / 24:.2f} ms/env-step], ppo "
          f"{100 * rows[2]['ms'] / full:.1f}%, disc {100 * rows[3]['ms'] / full:.1f}%, dagger "
          f"{rows[4]['ms']:.1f} ms every 20 iterations, residual {rows[5]['ms']:.1f} ms",
          flush=True)
    print(json.dumps({"device": label, "num_envs": N, "rounds": timing.ROUNDS, "rows": rows}))


if __name__ == "__main__":
    main()
