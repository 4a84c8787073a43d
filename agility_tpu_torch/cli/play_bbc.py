"""BBC evaluation entry point (counterpart of agility_tpu/cli/play_bbc.py).

Rolls a trained BBC policy for a fixed horizon with a chosen behaviour mode
and command, prints velocity-tracking and duty-factor statistics, and
optionally dumps the trajectory to .npz:

    python -m agility_tpu_torch.cli.play_bbc --device cuda --num_envs 4096 \
        --checkpoint logs/bbc_r5/bbc_15k.msgpack --mode trot --vx 1.0 --steps 250

Float32 matrix products and convolutions run in full float32: TF32 is
switched off for both, since the history encoder's convolution would
otherwise run in TF32 on the GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
from agility_tpu_torch.cli import registry
from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.policy import build_policy

WARMUP = 10  # leading control steps left out of the env-steps/s figure


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained BBC policy")
    p.add_argument("--task", default="go2_locomotion")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--mode", default="trot", choices=list(MOCAP_CATEGORIES))
    p.add_argument("--vx", type=float, default=1.0)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--dump", default=None, help="write trajectory .npz here")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args):
    """The play env (noise and domain randomization off), the policy and the
    held command: returns (env, policy, device, hold), where hold(state) sets
    the command and behaviour mode before each control step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("play_bbc: --device cuda but torch sees no CUDA device")

    cfg = registry.apply_overrides(
        registry.get(args.task)[0](),
        **{"env.num_envs": args.num_envs, "env.mocap_category": (args.mode,),
           "noise.add_noise": False, "domain_rand.push_robots": False,
           "domain_rand.randomize_friction": False, "domain_rand.randomize_base_mass": False,
           "domain_rand.randomize_base_com": False, "domain_rand.randomize_motor": False,
           "domain_rand.action_delay": False})
    env = Go2LocomotionEnv(cfg, device, seed=0)
    if args.checkpoint:
        print(f"loading {args.checkpoint}")
        weights = ckpt.params_from_jax(ckpt.read_msgpack(args.checkpoint))
    else:
        print("WARNING: no checkpoint given — evaluating an untrained policy")
        weights = None
    policy = build_policy(cfg, weights, device, seed=0)

    N = args.num_envs
    cmd = torch.tensor([args.vx, args.vy, args.wz, 0.0, 0.30], device=device).expand(N, 5)
    c = torch.nn.functional.one_hot(
        torch.full((N,), MOCAP_CATEGORIES.index(args.mode), device=device),
        len(MOCAP_CATEGORIES)).float()
    return env, policy, device, lambda state: state._replace(commands=cmd, latent_c=c)


def run(args) -> dict:
    """Build the env and policy, roll `args.steps` control steps and print
    the statistics.  Returns the env, the final LocoState, env-steps/s and
    the number of physics substeps run."""
    env, policy, device, hold = build(args)
    N = args.num_envs
    state = env.init_state()

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
    # substeps include init_state's zero-action step
    return dict(env=env, state=state, env_steps_per_s=steps_per_s,
                substeps=(args.steps + 1) * env.engine_cfg.decimation)


def main(argv=None):
    run(get_args(argv))


if __name__ == "__main__":
    main()
