"""Physics-engine throughput, the SoA path against the per-env engine
(counterpart of the JAX package's tools/bench_engine.py): control steps
alone, with the whole state fed back from step to step.

    python -m agility_tpu_torch.tools.bench_engine                 # both paths, one card
    BENCH_PATHS=soa python -m agility_tpu_torch.tools.bench_engine
    BENCH_ENVS=8 BENCH_STEPS=2 python -m agility_tpu_torch.tools.bench_engine --device cpu

The JAX tool's setup: BENCH_ENVS (4096) envs on a 600 x 600 grid at 0.05 m
of 0.06 N(0, 1) heights (default_rng(0), origin -15, -15), upright at
uniform(-10, 10) in x and y and z 0.45 in the default joint pose at rest,
PD targets at it (kp 40, kd 1), friction, gain scales, payload and CoM
shift drawn as the JAX tool draws them.  BENCH_PATHS (soa,vmap) names the
paths: "soa" is EngineConfig(soa=True), "vmap" the per-env engine,
EngineConfig(soa=False) (the JAX package's vmapped engine); both with
BENCH_LCP_ITERS (10) Jacobi sweeps.  Each path runs T = BENCH_STEPS (50)
control steps from that state, u fed back with the body forces, in
interleaved rounds (tools/timing.py, 5 rounds) on the synchronised host
clock; then one step's device operations (after all timing; not measured
on the CPU).  Prints ms a control step and env-steps/s (physics only) per
path, and a JSON line of the rows.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from agility_tpu_torch.tools import timing


def setup(N, device):
    """(mc, grid, state, control, params): the JAX tool's."""
    from agility_tpu_torch.core.urdf import build_go2_model
    from agility_tpu_torch.physics import engine as eng
    from agility_tpu_torch.physics import heightfield as hf
    from agility_tpu_torch.physics.constants import ModelConsts

    mc = ModelConsts.from_model(build_go2_model(), device)
    rng = np.random.default_rng(0)
    hmap = (0.06 * rng.normal(size=(600, 600))).astype(np.float32)
    grid = hf.from_numpy(hmap, 0.05, origin_xy=(-15.0, -15.0), device=device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    s = eng.EnvState(
        base_pos=f32(np.concatenate([rng.uniform(-10, 10, (N, 2)), np.full((N, 1), 0.45)], -1)),
        base_quat=f32([0, 0, 0, 1.0]).repeat(N, 1), dof_pos=mc.default_dof_pos.repeat(N, 1),
        u=torch.zeros((N, 18), device=device))
    control = eng.Control(target=mc.default_dof_pos.repeat(N, 1),
                          kp=torch.full((N, 12), 40.0, device=device),
                          kd=torch.full((N, 12), 1.0, device=device))
    params = eng.EnvParams(
        friction=f32(rng.uniform(0.5, 1.25, N)), kp_scale=f32(rng.uniform(0.9, 1.1, (N, 12))),
        kd_scale=f32(rng.uniform(0.9, 1.1, (N, 12))), added_base_mass=f32(rng.uniform(0, 1.5, N)),
        base_com_shift=f32(rng.uniform(-0.05, 0.05, (N, 3))))
    return mc, grid, s, control, params


def engine_config(path: str, iters: int):
    from agility_tpu_torch.physics.engine import EngineConfig

    if path not in ("soa", "vmap"):
        raise ValueError(f"bench_engine: unknown path {path!r} (soa, vmap)")
    return EngineConfig(soa=path == "soa", jacobi_iters=iters)


def bench(device, N=4096, T=50, paths=("soa", "vmap"), iters=10, rounds=timing.ROUNDS):
    """Each path's rows (timing.interleaved: ms a control step, launches a
    step; ops of one step; env_steps_per_s; finite: the last state)."""
    from agility_tpu_torch.physics import engine as eng

    mc, grid, s0, control, params = setup(N, device)
    last = {}

    def one(cfg, st):
        st2, taus, bf, _, _ = eng.step_batch(mc, cfg, grid, st, control, params)
        # everything fed back, so that no step is dead
        return st2._replace(u=st2.u + 1e-12 * bf[:, 0].sum(-1)[:, None])

    def roll(path, cfg):
        def go():
            st = s0
            for _ in range(T):
                st = one(cfg, st)
            last[path] = st
        return go

    cfgs = {p: engine_config(p, iters) for p in paths}
    with torch.no_grad():
        variants = [timing.Variant(p, roll(p, cfg), per=T, ops=lambda cfg=cfg: one(cfg, s0))
                    for p, cfg in cfgs.items()]
        rows = timing.interleaved(variants, device, rounds)
        timing.count_device_ops(rows, variants, device)
    for r in rows:
        r["env_steps_per_s"] = N / (r["ms"] * 1e-3)
        r["finite"] = all(bool(torch.isfinite(t).all()) for t in last[r["label"]])
        r["engine"] = dataclasses.asdict(cfgs[r["label"]])
    return rows


def main(argv=None):
    device, label = timing.open_device(argv, "physics-engine throughput, SoA vs per-env")
    N = int(os.environ.get("BENCH_ENVS", "4096"))
    T = int(os.environ.get("BENCH_STEPS", "50"))
    paths = os.environ.get("BENCH_PATHS", "soa,vmap").split(",")
    iters = int(os.environ.get("BENCH_LCP_ITERS", "10"))
    print(f"N={N}, T={T}, paths {paths}, {iters} sweeps, on {label}", flush=True)
    rows = bench(device, N, T, paths, iters)
    for r in rows:
        print(f"[{r['label']}] {r['ms']:.2f} ms/control-step batch [{r['ms_min']:.2f}, "
              f"{r['ms_max']:.2f}] @ {N} envs -> {r['env_steps_per_s']:,.0f} env-steps/s "
              f"(physics only); {r['ops'] or 'not measured'} device ops a step", flush=True)
    print(json.dumps({"device": label, "num_envs": N, "T": T, "rounds": timing.ROUNDS,
                      "rows": rows}))


if __name__ == "__main__":
    main()
