"""BBC training entry point (counterpart of agility_tpu/cli/train_bbc.py):

    python -m agility_tpu_torch.cli.train_bbc --task go2_locomotion --num_envs 4096 \
        --max_iterations 1500 [--resume] [--device cuda]

Checkpoints land in <log_root>/<experiment>/<experiment_idx>/ (see
learn/runner.py).  The JAX package's --multihost and --shard (a device
mesh) are not ported; --mocap_dir raises, as the env does: the port trains
on the synthetic clips.  TF32 is off for matrix products and convolutions.
"""
from __future__ import annotations

import argparse
import ast
import os

import torch

from agility_tpu_torch.cli import registry
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.runner import OnPolicyRunner

DR_FLAGS = ("push_robots", "randomize_friction", "randomize_base_mass", "randomize_base_com",
            "randomize_motor", "action_delay")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the BBC (go2_locomotion) policy")
    p.add_argument("--task", default="go2_locomotion")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--max_iterations", type=int, default=1500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--experiment_idx", type=int, default=0)
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", default=None, help="explicit checkpoint path")
    p.add_argument("--mocap_dir", default=None,
                   help="mocap dataset root; not supported by the port (synthetic clips)")
    p.add_argument("--log_root", default="logs")
    p.add_argument("--log_every", type=int, default=10)
    for flag in DR_FLAGS:
        p.add_argument(f"--no_{flag}", action="store_true", help=f"disable domain_rand.{flag}")
    p.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. "
                        "normalization.task_obs_weight_decay_steps=12000 "
                        "(repeatable; values parsed as python literals)")
    return p.parse_args(argv)


def build(args) -> OnPolicyRunner:
    """The env and the runner (resumed where asked), ready to learn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_bbc: --device cuda but torch sees no CUDA device")
    make_env_cfg, make_algo_cfg = registry.get(args.task)
    overrides = {"env.num_envs": args.num_envs, "seed": args.seed, "mocap_dir": args.mocap_dir}
    for flag in DR_FLAGS:
        if getattr(args, f"no_{flag}"):
            overrides[f"domain_rand.{flag}"] = False
    for ov in args.override:
        k, _, v = ov.partition("=")
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    cfg = registry.apply_overrides(make_env_cfg(), **overrides)

    log_dir = os.path.join(args.log_root, args.experiment_name or args.task,
                           str(args.experiment_idx))
    env = Go2LocomotionEnv(cfg, device, seed=args.seed)
    runner = OnPolicyRunner(env, make_algo_cfg(), log_dir=log_dir, seed=args.seed)
    if args.resume or args.checkpoint:
        path = args.checkpoint or ckpt.latest(log_dir)
        if path:
            print(f"resuming from {path}")
            runner.load(path)
        elif args.resume:
            print("no checkpoint found; starting fresh")
    return runner


def train(runner: OnPolicyRunner, args) -> OnPolicyRunner:
    runner.learn(args.max_iterations, init_at_random_ep_len=True, log_every=args.log_every)
    runner.save(runner.current_iteration)
    return runner


def run(args) -> OnPolicyRunner:
    return train(build(args), args)


def main(argv=None):
    run(get_args(argv))


if __name__ == "__main__":
    main()
