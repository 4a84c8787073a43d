"""Per-stage timing of the TSC teacher's training iteration (counterpart of
the JAX package's tools/bench_stages_tsc.py): the rollout (TSC policy,
set_commands, the frozen BBC, the env step, the disc reward), the PPO
update and DAgger read through the trainer's `timer` hook
(learn/ppo_tsc.py: TscPPO.timer, tools/timing.StageTimer), beside the env
step alone and the nets alone, 24 steps each.

    python -m agility_tpu_torch.tools.bench_stages_tsc              # BENCH_ENVS=6144, one card
    BENCH_ENVS=8 python -m agility_tpu_torch.tools.bench_stages_tsc --device cpu

The JAX tool's configuration: Go2AgilityCfg() (64 courses) at BENCH_ENVS
envs, a fresh frozen BBC (load_bbc_frozen(None, seed=0), drawn by torch:
not the JAX package's weights), TscAlgoCfg(), seeds as the bench's.  A
round is one train_iteration at it = 0 (DAgger due), then 24 env steps
with zero actions and no nets from the start state, then 24 steps of the
nets (estimator, both TSC heads, the hybrid sample with fixed noise, the
value, set_commands and the BBC's action, the action fed back into the
observations) from it; 5 interleaved rounds (tools/timing.py) after an
untimed one (the JAX tool times each in a lax.scan of BENCH_SCAN repeats).
Rows:
  full train_iteration          the iteration without DAgger (its stages)
  rollout (24 steps)            the rollout stage
  env.step x24 (no nets)        host clock
  nets x24 (policy+bbc+cmds)    host clock
  ppo_update                    the PPO stage
  dagger_update                 the DAgger stage (due every 20th iteration)
  rollout rest                  rollout - env - nets: the disc reward, the
                                rollout's bookkeeping
  residual                      full - rollout - ppo: the draws and GAE
plus "train_iteration, host clock".
"""
from __future__ import annotations

import json
import os

import torch

from agility_tpu_torch.tools import timing
from agility_tpu_torch.tools.bench_stages import iteration_variant

ROWS = ("full train_iteration", "rollout ({T} steps)", "env.step x{T} (no nets)",
        "nets x{T} (policy+bbc+cmds)", "ppo_update", "dagger_update", "rollout rest",
        "residual")


def labels(T=24):
    return [s.format(T=T) for s in ROWS]


def build(device, N=6144, T=None, cfg=None):
    """(alg, [ts, es, disc window]) on the JAX tool's configuration (`cfg`
    replaces it); `T` replaces the rollout's 24 steps."""
    from agility_tpu_torch.bench import tsc_config
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.io.checkpoint import load_bbc_frozen
    from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg, TscPPO

    env = Go2AgilityEnv(cfg or tsc_config(N), device, seed=1)
    algo = TscAlgoCfg() if T is None else TscAlgoCfg(num_steps_per_env=T)
    alg = TscPPO(env, load_bbc_frozen(None, seed=0), algo)
    es = env.init_state()
    return alg, [alg.init_train_state(), es, es.disc_obs[:, None].repeat(1, 2, 1)]


def env_only(alg, es0, T):
    """T env steps with zero actions from es0."""
    a = torch.zeros((alg.env.num_envs, 12), device=alg.device)

    def run():
        es = es0
        for _ in range(T):
            es, _ = alg.env.step(es, a)
    return run


def nets_only(alg, ts, es0, T):
    """T steps of the nets from es0: the estimator, both heads, the hybrid
    sample (the same noise every step, as the JAX tool's fixed key), the
    value, set_commands and the frozen BBC's action, fed back into the
    observations."""
    from agility_tpu_torch.learn import networks_tsc as tnets
    from agility_tpu_torch.learn.policy_tsc import bbc_act

    s = alg.slices
    d = alg.draw()
    gumbel, normal = d.gumbel[0], d.normal[0]
    std = ts.ac.std.detach()

    def run():
        es, obs = es0, es0.obs_buf
        for _ in range(T):
            obs_est = obs.clone()
            obs_est[:, s.explicit] = ts.est(obs[:, :s.n_prop_hist])
            logits_d, mean_c, _ = ts.ac.heads(obs_est, True)
            ts.ac.heads(obs_est, False)
            a = tnets.hybrid_sample(logits_d, mean_c, std, gumbel, normal)
            values = ts.ac.value(obs)
            es2, next_commands = alg.env.set_commands(es, a)
            actions_bbc = bbc_act(alg.bbc_ac, es.obs_bbc_buf, next_commands)
            obs = obs + 1e-6 * actions_bbc.sum() + 1e-6 * values[:, None]
            es = es2
    return run


def stage_rows(T):
    names = labels(T)

    def rows_of(st):
        full = sum(v for k, v in st.items() if k not in ("dagger", "end"))
        return {names[0]: full, names[1]: st["rollout"], names[4]: st["ppo"],
                names[5]: st["dagger"], names[7]: full - st["rollout"] - st["ppo"]}
    return rows_of


def bench(device, N=6144, T=None, rounds=timing.ROUNDS, cfg=None):
    """The rows, in ROWS' order, then the host clock's."""
    alg, state = build(device, N, T, cfg)
    T = alg.cfg.num_steps_per_env
    names = labels(T)
    ts, es0 = state[0], state[1]
    env_run, nets_run = env_only(alg, es0, T), nets_only(alg, ts, es0, T)
    variants = [iteration_variant(alg, state, stage_rows(T)),
                timing.Variant(names[2], lambda: _no_grad(env_run)),
                timing.Variant(names[3], lambda: _no_grad(nets_run))]
    rows = timing.interleaved(variants, device, rounds)
    by = {r["label"]: r for r in rows}
    rest = [a - b - c for a, b, c in zip(by[names[1]]["rounds"], by[names[2]]["rounds"],
                                         by[names[3]]["rounds"])]
    by[names[6]] = dict(label=names[6], **timing.spread(rest), first_s=None, launches={},
                        ops=None)
    return [by[k] for k in names] + [by["train_iteration, host clock"]]


def _no_grad(fn):
    with torch.no_grad():
        return fn()


def main(argv=None):
    device, label = timing.open_device(argv, "TSC train-iteration stages")
    N = int(os.environ.get("BENCH_ENVS", "6144"))
    print(f"N={N} envs, {timing.ROUNDS} rounds, on {label}", flush=True)
    rows = bench(device, N)
    print(timing.table(rows, "iteration"), flush=True)
    ms = [r["ms"] for r in rows]
    print(f"\nfull {ms[0]:.1f} ms = rollout {ms[1]:.1f} (env {ms[2]:.1f} + nets {ms[3]:.1f} + rest "
          f"{ms[6]:.1f}) + ppo {ms[4]:.1f} + residual {ms[7]:.1f}; dagger/20 {ms[5] / 20:.1f}")
    print(f"env-steps/s (full): {24 * N / ms[0] * 1e3:,.0f}")
    print(json.dumps({"device": label, "num_envs": N, "rounds": timing.ROUNDS, "rows": rows}))


if __name__ == "__main__":
    main()
