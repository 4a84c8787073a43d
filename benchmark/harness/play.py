"""The "play" traffic kind: evaluation play of a trained BBC through the
program's CLI (`cli/play_bbc.build`), as `play_bbc.run` plays it:
`env.step(hold(state), policy(state.obs_buf))`, one control step at a time,
each step timed on the host clock to the end of its device work.

Set-up builds the env and the policy, seeds the env's generator and runs
the traffic's warm steps.  The window runs control steps until the first
that ends at or after `seconds`; at a few steps drawn from the seed it
keeps the input state, the generator state, the actions and the output,
which the reference judges after the window."""
from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from benchmark.harness import common
from benchmark.harness import trace as tr
from benchmark.harness import yardstick as ys
from benchmark.reference import bbc as ref
from benchmark.reference import core


def build(cfg: Dict, traffic: Dict, seed: int, device: str):
    cli = common.cli_module(cfg["play"]["cli"])
    argv = list(cfg["play"]["argv"]) + [
        "--device", device, "--checkpoint", traffic["checkpoint"], "--mode", traffic["mode"],
        "--vx", str(traffic["vx"]), "--vy", str(traffic["vy"]), "--wz", str(traffic["wz"])]
    with common.quiet():
        env, policy, _, hold = cli.build(cli.get_args(argv),
                                         overrides=dict(cfg["play"].get("overrides", {}),
                                                        seed=seed))
    env.gen.manual_seed(seed)
    return env, policy, hold


def window(env, policy, hold, state, seconds: float, device: str, sampled, traced: bool):
    """Control steps until the first that ends at or after `seconds`."""
    from agility_tpu_torch.physics import engine

    spans = flops = k1 = None
    act = policy
    if traced:
        spans, flops, k1 = tr.Spans(), tr.FlopCounter(), tr.K1Shapes()
        spans.wrap(engine, "step_batch", "engine")
        act = spans.around("policy", policy)
        flops.start()
        k1.start()
    watch = common.HostWatch(device)
    watch.begin()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, records, n = [], [], 0
    t0 = time.perf_counter()
    try:
        while True:
            ts = time.perf_counter()
            state = hold(state)
            if n in sampled:
                gen, s_in = env.gen.get_state(), common.clone_state(state)
            actions = act(state.obs_buf)
            state, out = env.step(state, actions)
            if n in sampled:
                records.append(dict(pos=n, state_in=s_in, gen=gen, actions=actions.clone(),
                                    state_out=common.clone_state(state), rew=out.rew.clone()))
            common.sync(device)
            te = time.perf_counter()
            times.append(te - ts)
            n += 1
            if te - t0 >= seconds:
                break
    finally:
        if traced:
            flops.stop()
            k1.stop()
            spans.restore()
    host_watch = watch.end()
    out = dict(window_s=te - t0, steps=n, step_s=times, state=state,
               memory_peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
               records=common.host(records), host=host_watch)
    if traced:
        out.update(policy_ms=spans.elapsed_ms("policy"), engine_ms=spans.elapsed_ms("engine"),
                   flops=flops.total(), k1_shapes=k1.shapes)
    return out


def profiled_slice(env, policy, hold, state, steps: int, k1_shapes) -> Dict:
    sl = tr.Slice()
    sl.start()
    for _ in range(steps):
        state = hold(state)
        state, _ = env.step(state, policy(state.obs_buf))
    sl.stop()
    return common.slice_readings(sl, steps, k1_shapes)


def judge(cfg: Dict, traffic: Dict, records, seed: int, device: str,
          control: bool = False) -> Dict:
    """The reference's whole control step (its policy, its weights read from
    the checkpoint file, then its env's step) from each recorded input state:
    the widest gap of the new state, its outlying envs, and the widest gap of
    the actions; with `control`, the same numbers of the reference computed
    with TF32 in the program's place, against the float32 reference, and of
    an answer altered in one env."""
    core.tf32(False)
    overrides = dict(cfg["reference"]["play_overrides"], seed=seed)
    overrides["env.mocap_category"] = [traffic["mode"]]
    env = ref.make_env(overrides, device, seed)
    policy = ref.play_policy(traffic["checkpoint"], env.cfg, device)
    recs = [common.to_device(r, device) for r in records]
    steps = [ref.control_step(env, policy, r["state_in"], r["gen"].cpu()) for r in recs]
    action = [core.rel_gap(r["actions"], a) for r, (a, _, _) in zip(recs, steps)]
    gaps = [ref.state_gap(r["state_out"], r["rew"], s_ref, o_ref.rew)
            for r, (_, s_ref, o_ref) in zip(recs, steps)]
    numbers = dict(step_gap=max((g["gap"] for g in gaps), default=float("inf")),
                   env_outliers=sum(g["outliers"] for g in gaps) if gaps else float("inf"),
                   action_gap=max(action, default=float("inf")))
    result = dict(numbers=numbers, env_gaps=gaps)
    if control:
        ctrl = [ref.control_step(env, policy, r["state_in"], r["gen"].cpu(), with_tf32=True)
                for r in recs]
        g19 = [ref.state_gap(s19, o19.rew, s32, o32.rew)
               for (_, s19, o19), (_, s32, o32) in zip(ctrl, steps)]
        one = [core.fault_gaps(r["state_in"], s_ref, o_ref.rew, ref.state_gap)["one_env"]
               for r, (_, s_ref, o_ref) in zip(recs, steps)]
        result["control"] = dict(
            tf32=dict(step_gap=max(g["gap"] for g in g19),
                      env_outliers=sum(g["outliers"] for g in g19),
                      action_gap=max(core.rel_gap(a19, a32)
                                     for (a19, _, _), (a32, _, _) in zip(ctrl, steps))),
            one_env=dict(step_gap=max(g["gap"] for g in one),
                         env_outliers=sum(g["outliers"] for g in one)))
    return result


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
        control: bool = False, fault=None) -> Dict:
    """One run: set-up, the window, (traced) the profiled slice, then the
    reference. `fault`, for the harness's own tests, breaks the program
    after set-up's build (a callable taking the env)."""
    t0 = time.perf_counter()
    env, policy, hold = build(cfg, traffic, seed, device)
    if fault is not None:
        fault(env)
    state = env.init_state()
    for _ in range(traffic["warm_steps"]):
        state = hold(state)
        state, _ = env.step(state, policy(state.obs_buf))
    common.sync(device)
    setup_s = time.perf_counter() - t0
    sampled = {p[0] for p in common.sample_positions(seed, 2, traffic["check_steps"],
                                                     (traffic["check_range"],))}
    win = window(env, policy, hold, state, seconds, device, sampled, traced)
    readings = {k: v for k, v in win.items() if k not in ("state", "records", "step_s")}
    N = env.num_envs
    if traced and device == "cuda":
        readings["slice"] = profiled_slice(env, policy, hold, win["state"],
                                           traffic["profile_steps"], win["k1_shapes"])
    records = win.pop("records")
    del env, policy, hold, state, win["state"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judged = judge(cfg, traffic, records, seed, device, control)
    judged["seconds"] = time.perf_counter() - t_judge
    step_ms = [1e3 * s for s in win["step_s"]]
    e2e = dict(setup_s=setup_s, play_env_steps_per_s=win["steps"] * N / win["window_s"],
               play_step_ms_p90=ys.percentile_nearest_rank(step_ms, 90))
    return dict(end_to_end=e2e, readings=readings, memory_peak=win["memory_peak"],
                attempted=win["steps"], numbers=judged["numbers"], judged=judged)
