"""Env-layer cost attribution by ablation (counterpart of the JAX package's
tools/bench_env_ablate.py): time the full BBC env step, then time it again
with one piece stubbed out, each on the root bench's configuration
(agility_tpu_torch/bench.py:bbc_config).  The differences attribute the
env layer's cost outside physics.

    python -m agility_tpu_torch.tools.bench_env_ablate          # BENCH_ENVS=4096, one card
    BENCH_ENVS=8 python -m agility_tpu_torch.tools.bench_env_ablate --device cpu

Each variant acts with tanh(obs_buf[:, :12]) for T = 48 steps, three
times, after one untimed pass of T steps (the JAX tool's compile pass:
here the first calls and the stubs' shapes), and prints ms/step
(synchronised host clock) and, on the card, the device operations one step
issues, counted with torch.profiler as tools/count_ops.py counts them (the
step is host-bound, so ms alone mix the piece's cost with the host's speed;
on the CPU: not measured).  Every variant is timed before any is
profiled, since a profiler session slows the host's later launches; the
full step is timed once more after the counts.  A last line gives every
row as JSON.

Every variant starts from the same state and the same generator state,
and patches one env: a stubbed method is an instance attribute, removed
again when the variant ends (a variant cannot leak into the next).  A stub
returns zeros of the shapes and dtypes the real method returns (the real
method runs once, at the stub's first call: the port's jax.eval_shape),
except the JAX tool's two pass-throughs: `_reset_where` returns the state
and `_center_root_height` the world z.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

T, REPS = 48, 3


def act(s):
    return torch.tanh(s.obs_buf[:, :12])


def zeros_like_tree(x):
    """Zeros of the shapes and dtypes of a tensor or a (named) tuple of them."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    if hasattr(x, "_fields"):
        return type(x)(*map(zeros_like_tree, x))
    return type(x)(map(zeros_like_tree, x))


def zeros_stub(method):
    """A stand-in for `method` that returns zeros of its output's shapes and
    dtypes: `method` runs once, at the first call, on that call's inputs."""
    out = []

    def stub(*args, **kwargs):
        if not out:
            out.append(zeros_like_tree(method(*args, **kwargs)))
        return out[0]
    return stub


@contextlib.contextmanager
def patched(env, **attrs):
    """`env` with the given attributes set (a method stubbed, the config
    replaced) for the body; afterwards, whatever happened, the instance's
    own attributes are restored and the stubs removed."""
    saved = {k: env.__dict__[k] for k in attrs if k in env.__dict__}
    try:
        for k, v in attrs.items():
            setattr(env, k, v)
        yield env
    finally:
        for k in attrs:
            if k in saved:
                setattr(env, k, saved[k])
            else:
                vars(env).pop(k, None)


def start(env):
    """The state every variant starts from (the unpatched env's
    init_state) and the env generator's state after it."""
    s = env.init_state()
    return s, env.gen.get_state()


def bench(env, label, begin, T=T, reps=REPS, **patches):
    """One variant timed: `env` with `patches` (patched()) stepped from
    `begin` (start()) for an untimed pass of T steps, then `reps` timed
    passes.  Prints and returns its row: ms a step, the untimed pass's
    seconds, the kernel launches a timed step, whether the rewards stayed
    finite, and `ops` (None; run_variants() counts them)."""
    from agility_tpu_torch.kernels import launch_counts

    cuda = env.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def run(s):
        for _ in range(T):
            s, out = env.step(s, act(s))
        return s, out.rew

    s, gen_state = begin
    env.gen.set_state(gen_state)
    with patched(env, **patches), torch.no_grad():
        t0 = time.perf_counter()
        s, r = run(s)
        sync()
        first_s = time.perf_counter() - t0
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            s, r = run(s)
        sync()
        dt = (time.perf_counter() - t0) / reps / T
        launches = {k: (v - before[k]) / (reps * T) for k, v in launch_counts().items()}
    print(f"{label:<28} {dt * 1e3:8.2f} ms/step   (first pass {first_s:.1f}s)", flush=True)
    return dict(label=label, ms=dt * 1e3, ops=None, first_s=first_s, launches=launches,
                finite=bool(torch.isfinite(r).all()))


def device_ops(env, begin, **patches):
    """The device operations of one step of `env` with `patches` from
    `begin`, after bench() ran the variant (its stubs' shapes taken); None
    on the CPU (not measured)."""
    from agility_tpu_torch.tools.count_ops import ops_of

    if env.device.type != "cuda":
        return None
    s, gen_state = begin
    env.gen.set_state(gen_state)
    with patched(env, **patches), torch.no_grad():
        return ops_of(lambda: env.step(s, act(s)), env.device)


def run_variants(env, variants, T=T, reps=REPS):
    """Every (label, patches) of `variants(env)` timed from the same start
    (bench()); then, on the card, each one's device operations counted and
    the full step timed once more.  The counts come after all timing: a
    torch.profiler session slows the host's later launches, and the last
    full step measures by how much.  Prints the table; returns (rows, that
    last full step's row, or None on the CPU)."""
    begin = start(env)
    vs = variants(env)
    rows = [bench(env, label, begin, T, reps, **patches) for label, patches in vs]
    again = None
    if env.device.type == "cuda":
        for row, (_, patches) in zip(rows, vs):
            row["ops"] = device_ops(env, begin, **patches)
        again = bench(env, "full step, after the counts", begin, T, reps)
    for r in rows:
        print(f"{r['label']:<28} {r['ms']:8.2f} ms/step  {r['ops'] or 'not measured':>12} "
              "device ops/step", flush=True)
    return rows, again


def variants(env):
    """(label, patches) of each variant, in the JAX tool's order."""
    cfg = env.cfg
    no_mocap = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, mocap_state_init=False))
    return [("full step", {}),
            ("reset w/o mocap frames", dict(cfg=no_mocap)),
            ("no _reset_where", dict(_reset_where=lambda state, mask: state)),
            ("no _compute_observations",
             dict(_compute_observations=zeros_stub(env._compute_observations))),
            ("no _compute_reward", dict(_compute_reward=zeros_stub(env._compute_reward))),
            ("no _center_root_height",
             dict(_center_root_height=lambda base_pos, base_quat: base_pos[:, 2]))]


def ablate(env, T=T, reps=REPS):
    """run_variants() of the BBC variants."""
    return run_variants(env, variants, T, reps)


def run_tool(argv, make_env, ablate_fn, default_envs):
    """A tool's entry point: --device (the card unless asked), BENCH_ENVS
    envs (`default_envs` unset), make_env(n, device), ablate_fn(env), then
    the rows as one JSON line."""
    from agility_tpu_torch.bench import device_label

    p = argparse.ArgumentParser(description="env-layer cost attribution by ablation")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(os.environ.get("BENCH_ENVS", str(default_envs)))
    label = device_label(device)
    print(f"{n} envs on {label}", flush=True)
    rows, again = ablate_fn(make_env(n, device))
    print(json.dumps({"device": label, "num_envs": n, "T": T, "reps": REPS, "rows": rows,
                      "full_step_after_counts": again}))


def main(argv=None):
    from agility_tpu_torch.bench import bbc_config
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv

    run_tool(argv, lambda n, device: Go2LocomotionEnv(bbc_config(n), device), ablate, 4096)


if __name__ == "__main__":
    main()
