"""TSC teacher training entry point (counterpart of the teacher phase of
agility_tpu/cli/train_tsc.py):

    python -m agility_tpu_torch.cli.train_tsc --bbc_path logs/bbc_r5/bbc_final.msgpack \\
        --randomize_start --randomize_base_mass --randomize_base_com --push_robots \\
        [--num_envs 6144] [--max_iterations 30000] [--resumeid 000] [--device cuda]

Checkpoints land in <log_root>/<proj_name>/<exptid>/ (see
learn/runner_tsc.py); --resumeid continues from the newest one of that
experiment.  `--debug` trains 64 envs on 8 courses.  The depth student
(--use_camera) is not ported yet, nor the JAX package's --multihost and
--shard (a device mesh).  TF32 is off for matrix products and
convolutions.
"""
from __future__ import annotations

import argparse
import os

import torch

from agility_tpu_torch.cli import registry
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.runner_tsc import TscOnPolicyRunner

DR_FLAGS = ("randomize_base_mass", "randomize_base_com", "push_robots")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the TSC agility policy (teacher)")
    p.add_argument("--proj_name", default="agility")
    p.add_argument("--exptid", default="000")
    p.add_argument("--resumeid", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--courses", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--bbc_path", default=None,
                   help="BBC checkpoint for the frozen low-level policy")
    p.add_argument("--use_camera", action="store_true",
                   help="student phase: depth-camera distillation (not ported yet)")
    p.add_argument("--obstacle_curriculum", action="store_true")
    # the reference's teacher-training flags
    p.add_argument("--randomize_start", action="store_true",
                   help="spawn reset envs at a random station's approach goal")
    for flag in DR_FLAGS:
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--reset_std", type=float, default=None,
                   help="on resume, reset the continuous-head std to this value")
    p.add_argument("--log_root", default="logs")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--debug", action="store_true", help="64 envs, 8 courses")
    return p.parse_args(argv)


def build(args) -> TscOnPolicyRunner:
    """The env and the runner (resumed where asked), ready to learn."""
    if args.use_camera:
        raise NotImplementedError("train_tsc --use_camera: the depth student is not ported yet")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_tsc: --device cuda but torch sees no CUDA device")
    make_env_cfg, make_algo_cfg = registry.get("go2")
    if args.debug:
        cfg = tsc_smoke_cfg(num_envs=64, courses=8)
    else:
        cfg = registry.apply_overrides(make_env_cfg(), seed=args.seed)
    overrides = {"env.num_envs": args.num_envs, "obstacle.courses": args.courses}
    if args.obstacle_curriculum:
        overrides["obstacle.curriculum"] = True
    if args.randomize_start:
        overrides["env.randomize_start"] = True
    for flag in DR_FLAGS:
        if getattr(args, flag):
            overrides[f"domain_rand.{flag}"] = True
    cfg = registry.apply_overrides(cfg, **overrides)

    log_dir = os.path.join(args.log_root, args.proj_name, args.exptid)
    env = Go2AgilityEnv(cfg, device, seed=args.seed)
    runner = TscOnPolicyRunner(env, ckpt.load_bbc_frozen(args.bbc_path, seed=args.seed),
                               make_algo_cfg(), log_dir=log_dir, seed=args.seed)
    if args.resumeid:
        path = ckpt.latest(os.path.join(args.log_root, args.proj_name, args.resumeid))
        if path:
            print(f"resuming teacher from {path}")
            runner.load(path)
            if args.reset_std is not None:
                with torch.no_grad():
                    runner.train_state.ac.std.fill_(args.reset_std)
                print(f"continuous-head std reset to {args.reset_std}")
    return runner


def train(runner: TscOnPolicyRunner, args) -> TscOnPolicyRunner:
    runner.learn(args.max_iterations, log_every=args.log_every)
    runner.save(runner.current_iteration)
    return runner


def run(args) -> TscOnPolicyRunner:
    return train(build(args), args)


def main(argv=None):
    run(get_args(argv))


if __name__ == "__main__":
    main()
