"""BBC training entry point (counterpart of agility_tpu/cli/train_bbc.py):

    python -m agility_tpu_torch.cli.train_bbc --task go2_locomotion --num_envs 4096 \
        --max_iterations 1500 [--resume] [--device cuda] [--mocap_dir D]
    torchrun --standalone --nproc_per_node 4 -m agility_tpu_torch.cli.train_bbc \
        --task go2_locomotion_32k --shard

Checkpoints land in <log_root>/<experiment>/<experiment_idx>/ (see
learn/runner.py).  With --mocap_dir the env's reset poses and the
discriminator's expert transitions come from the clips under
D/mocap_all_lb (labelled, the category in each file name) and
D/mocap_all_ulb (unlabelled, optional), read by envs/mocap.load_dir;
without it, from the synthetic gait clips.  --shard splits the
--num_envs global envs over the ranks of the group torchrun starts (one
per card, cuda:LOCAL_RANK, NCCL; gloo with --device cpu; one rank without
torchrun) with the parameters replicated: the run is the one-rank run of
its seed, partitioned by env (dist/mesh.py).  --multihost is --shard over
torchrun's multi-node rendezvous.  TF32 is off for matrix products and
convolutions.
"""
from __future__ import annotations

import argparse
import ast
import os

import torch

from agility_tpu_torch.cli import registry
from agility_tpu_torch.dist import mesh
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
                   help="mocap dataset root (contains mocap_all_lb/ and "
                        "mocap_all_ulb/); synthetic gaits if omitted")
    p.add_argument("--log_root", default="logs")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's multi-node group (one process per card on "
                        "every host); implies --shard")
    p.add_argument("--shard", action="store_true",
                   help="split the global --num_envs over the group's ranks, one per "
                        "card (replicated parameters, data parallel)")
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
    shard = None
    if args.shard or args.multihost:
        shard, device = mesh.join(device, cfg.env.num_envs, args.multihost)
    env = Go2LocomotionEnv(cfg, device, seed=args.seed, shard=shard)
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
    try:
        run(get_args(argv))
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
