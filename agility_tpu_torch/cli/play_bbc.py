"""BBC evaluation entry point (counterpart of agility_tpu/cli/play_bbc.py).

Rolls a trained BBC policy for a fixed horizon with a chosen behaviour mode
and command, prints velocity-tracking and duty-factor statistics, and
optionally dumps the trajectory to .npz:

    python -m agility_tpu_torch.cli.play_bbc --device cuda --num_envs 4096 \\
        --checkpoint logs/bbc_r5/bbc_15k.msgpack --mode trot --vx 1.0 --steps 250 \\
        [--gait_bands agility_tpu_torch/assets/gait_bands_real.json]

The checkpoint is --checkpoint or, without it, the newest model_<n>.msgpack
in <log_root>/<task>/<experiment_idx>/ (where train_bbc writes).
--compare_gait measures the rollout's gait (duty factor, stride frequency,
diagonal sync; io/gait.py) after a 100-step transient and checks it against
the mode's bands: those of --gait_bands (a bands JSON, e.g. the real-clip
bands in assets/gait_bands_real.json), or else bands derived from the env's
labelled clips (--mocap_dir, or the synthetic ones).  `main` exits 1 when
the gait fails its bands and 2 when the mode has no clips to compare with;
`run` returns the verdict.  --interactive plays under curses with keyboard
commands (cli/interactive.py), every mode switchable.

Float32 matrix products and convolutions run in full float32: TF32 is
switched off for both, since the history encoder's convolution would
otherwise run in TF32 on the GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from agility_tpu_torch import trace
from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
from agility_tpu_torch.cli import registry
from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.io import gait
from agility_tpu_torch.learn.policy import build_policy
from agility_tpu_torch.kernels.free_dynamics import free_dynamics
from agility_tpu_torch.physics.soa import CONTACT_APPLY, FREE_DYNAMICS

WARMUP = 10  # leading control steps left out of the env-steps/s figure
TRANSIENT = 100  # leading control steps left out of the gait statistics (when steps > 200)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained BBC policy")
    p.add_argument("--task", default="go2_locomotion")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--log_root", default="logs")
    p.add_argument("--experiment_idx", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--mode", default="trot", choices=list(MOCAP_CATEGORIES))
    p.add_argument("--vx", type=float, default=1.0)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--mocap_dir", default=None)
    p.add_argument("--dump", default=None, help="write trajectory .npz here")
    p.add_argument("--compare_gait", action="store_true",
                   help="check rollout gait statistics against per-mode bands derived "
                        "from the mocap clips (io/gait.py); exits 1 on failure")
    p.add_argument("--gait_bands", default=None,
                   help="path to a bands artifact (tools/make_gait_bands.py; the real-clip "
                        "bands are agility_tpu_torch/assets/gait_bands_real.json); implies "
                        "--compare_gait and replaces the live-derived bands")
    p.add_argument("--trace", action="store_true",
                   help="record spans over the program's layers (agility_tpu_torch/trace.py) "
                        "and print each one's calls and ms at the end")
    p.add_argument("--interactive", action="store_true",
                   help="curses keyboard play: live telemetry panel, W/S/A/D velocity, 1-5 "
                        "mode, height keys")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args, overrides=None):
    """The play env (noise and domain randomization off; one mode, or all
    with --interactive), the policy and the held command: returns (env,
    policy, device, hold), where hold(state) sets the command and behaviour
    mode before each control step.  `overrides` are further dotted-key
    config overrides (registry.apply_overrides), e.g. {"sim.solver": "soft"}
    for another contact model.  With --trace, tracing is on from here."""
    if args.trace:
        trace.enable(args.device)
    with trace.span("build", sync=True):
        return _build(args, overrides)


def _build(args, overrides):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("play_bbc: --device cuda but torch sees no CUDA device")

    cfg = registry.get(args.task)[0]()
    cfg = registry.apply_overrides(
        cfg, **{"env.num_envs": args.num_envs,
                "env.mocap_category": (cfg.env.mocap_category if args.interactive
                                       else (args.mode,)),
                "mocap_dir": args.mocap_dir,
                "noise.add_noise": False, "domain_rand.push_robots": False,
                "domain_rand.randomize_friction": False,
                "domain_rand.randomize_base_mass": False,
                "domain_rand.randomize_base_com": False,
                "domain_rand.randomize_motor": False, "domain_rand.action_delay": False})
    cfg = registry.apply_overrides(cfg, **(overrides or {}))
    with trace.span("build.env"):
        env = Go2LocomotionEnv(cfg, device, seed=0)
    path = args.checkpoint or ckpt.latest(
        os.path.join(args.log_root, args.task, str(args.experiment_idx)))
    with trace.span("build.checkpoint"):
        if path:
            print(f"loading {path}")
            weights = ckpt.params_from_jax(ckpt.read_msgpack(path))
        else:
            print("WARNING: no checkpoint found — evaluating an untrained policy")
            weights = None
        policy = build_policy(cfg, weights, device, seed=0)

    N = args.num_envs
    cmd = torch.tensor([args.vx, args.vy, args.wz, 0.0, 0.30], device=device).expand(N, 5)
    c = torch.nn.functional.one_hot(
        torch.full((N,), MOCAP_CATEGORIES.index(args.mode), device=device),
        len(MOCAP_CATEGORIES)).float()
    return env, policy, device, lambda state: state._replace(commands=cmd, latent_c=c)


def compare_gait(args, env, contact):
    """The rollout's gait statistics (after the transient) against the
    mode's bands: (stats, bands, verdict); bands {} and verdict None when
    the mode has no clips."""
    stats = gait.gait_stats(contact[TRANSIENT:] if len(contact) > 2 * TRANSIENT else contact,
                            env.dt)
    mode_idx = MOCAP_CATEGORIES.index(args.mode)
    if args.gait_bands:
        with open(args.gait_bands) as f:
            stored = json.load(f)[args.mode]
        bands = {k: tuple(v) for k, v in stored.items() if k != "clips"}
    else:
        bands = gait.bands_from_motion(env.motion.host(), mode_idx)
    if not bands:
        print(f"no mocap clips for mode {args.mode}; cannot compare")
        return stats, bands, None
    verdict = gait.compare(stats, bands)
    print(gait.format_report(stats, bands, verdict))
    return stats, bands, verdict


def run(args, overrides=None) -> dict:
    """Build the env and policy (`overrides` as in `build`), roll
    `args.steps` control steps and print the statistics (and, with
    --compare_gait or --gait_bands, the gait report).  Returns the env, the
    policy and the command hold, the final LocoState, env-steps/s, the
    number of physics substeps run, the trajectory (numpy, (steps, N, ...))
    and the gait comparison (stats, bands, verdict) or None."""
    env, policy, device, hold = build(args, overrides)
    N = args.num_envs
    state = env.init_state()
    if args.interactive:
        from agility_tpu_torch.cli import interactive

        state = interactive.run(env, policy, state, mode_idx=MOCAP_CATEGORIES.index(args.mode),
                                vx=args.vx, vy=args.vy, wz=args.wz)
        return dict(env=env, state=state)

    traj = {"base_pos": [], "base_vel": [], "dof_pos": [], "contact": []}
    t0 = None
    for i in range(args.steps):
        if i == min(WARMUP, args.steps - 1):
            _sync(device)
            t0 = time.perf_counter()
        state = hold(state)
        state, _ = env.step(state, policy(state.obs_buf))
        traj["base_pos"].append(state.sim.base_pos)
        traj["base_vel"].append(qm.quat_rotate_inverse(state.sim.base_quat, state.sim.u[:, :3]))
        traj["dof_pos"].append(state.sim.dof_pos)
        traj["contact"].append(state.contact_filt)
    _sync(device)
    timed = args.steps - min(WARMUP, args.steps - 1)
    steps_per_s = N * timed / (time.perf_counter() - t0)

    traj = {k: torch.stack(v).cpu().numpy() for k, v in traj.items()}
    track_err = np.abs(traj["base_vel"][:, :, 0] - args.vx)
    duty = traj["contact"].mean(axis=(0, 1))
    print(f"mode={args.mode} cmd vx={args.vx}: "
          f"|vx err| mean {track_err.mean():.3f} (last-100 {track_err[-100:].mean():.3f})")
    print(f"duty factors FL/FR/RL/RR: {np.array2string(duty, precision=2)}")
    print(f"env-steps/s {steps_per_s:.1f} over {timed} steps x {N} envs on {device}")
    if args.dump:
        np.savez(args.dump, **traj)
        print(f"trajectory written to {args.dump}")
    compared = (compare_gait(args, env, traj["contact"])
                if args.compare_gait or args.gait_bands else None)
    if trace.ON:
        print_spans()
    # substeps include init_state's zero-action step
    return dict(env=env, policy=policy, hold=hold, state=state, env_steps_per_s=steps_per_s,
                substeps=(args.steps + 1) * env.engine_cfg.decimation, traj=traj,
                gait=compared)


def print_spans() -> None:
    """Each span's calls, ms (CUDA-event time where recorded, else host) and
    ms a call, in the order they first closed; then how often the SoA
    substep's two CUDA graphs were captured and replayed, and how often the
    free-dynamics kernel was called (two a capture of the first graph, none
    a replay)."""
    for name, st in trace.summary().items():
        ms = st["device_ms"] if st["device_ms"] is not None else st["host_ms"]
        print(f"span {name:<22} {st['count']:7d} calls {ms:12.3f} ms "
              f"{ms / st['count']:10.4f} ms a call  (in {st['parent']})")
    print(f"free dynamics graph: {FREE_DYNAMICS.captures} captures, "
          f"{FREE_DYNAMICS.replays} replays; free dynamics kernel: "
          f"{free_dynamics.launches} calls")
    print(f"contact apply graph: {CONTACT_APPLY.captures} captures, "
          f"{CONTACT_APPLY.replays} replays")


def main(argv=None):
    res = run(get_args(argv))
    if res.get("gait") is not None:
        _, bands, verdict = res["gait"]
        if not bands:
            raise SystemExit(2)
        if not verdict["ok"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
