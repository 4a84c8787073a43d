"""TSC env-layer cost attribution by ablation (counterpart of the JAX
package's tools/bench_env_ablate_tsc.py): time the full Go2AgilityEnv step
on the TSC task's config (64 courses), then time it again with one piece
stubbed out; the method is bench_env_ablate.py's.

    python -m agility_tpu_torch.tools.bench_env_ablate_tsc      # BENCH_ENVS=6144, one card
    BENCH_ENVS=8 python -m agility_tpu_torch.tools.bench_env_ablate_tsc --device cpu

Stubs return zeros of the real method's output shapes and dtypes, except
`_reset_where`, which returns the state.  Under "no _measure_heights" the
scandot kernel (K3) is not launched; under "no _compute_observations"
neither, since the observations are what read the scandots.
"""
from __future__ import annotations

from agility_tpu_torch.tools.bench_env_ablate import REPS, T, run_tool, run_variants, zeros_stub


def variants(env):
    """(label, patches) of each variant, in the JAX tool's order."""
    return [("full step", {}),
            ("no _compute_observations",
             dict(_compute_observations=zeros_stub(env._compute_observations))),
            ("no _measure_heights", dict(_measure_heights=zeros_stub(env._measure_heights))),
            ("no _compute_reward", dict(_compute_reward=zeros_stub(env._compute_reward))),
            ("no _reset_where", dict(_reset_where=lambda state, mask, draws=None: state))]


def ablate(env, T=T, reps=REPS):
    """bench_env_ablate.run_variants() of the TSC variants."""
    return run_variants(env, variants, T, reps)


def main(argv=None):
    from agility_tpu_torch.bench import tsc_config
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv

    run_tool(argv, lambda n, device: Go2AgilityEnv(tsc_config(n), device), ablate, 6144)


if __name__ == "__main__":
    main()
