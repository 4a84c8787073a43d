"""TSC training entry point (counterpart of agility_tpu/cli/train_tsc.py).

Teacher phase:
    python -m agility_tpu_torch.cli.train_tsc --bbc_path logs/bbc_r5/bbc_final.msgpack \\
        --randomize_start --randomize_base_mass --randomize_base_com --push_robots \\
        [--num_envs 6144] [--max_iterations 30000] [--resumeid 000] [--device cuda]
    torchrun --standalone --nproc_per_node 4 -m agility_tpu_torch.cli.train_tsc \\
        --task go2_32k --shard --bbc_path logs/bbc_r5/bbc_final.msgpack
Student phase (depth distillation, learn/vision_tsc.py):
    python -m agility_tpu_torch.cli.train_tsc --use_camera \\
        --bbc_path logs/bbc_r5/bbc_final.msgpack --log_root logs --proj_name agility \\
        --resumeid r5 --exptid vis [--num_envs 256]

Checkpoints land in <log_root>/<proj_name>/<exptid>/ (see
learn/runner_tsc.py); in the teacher phase --resumeid continues from the
newest one of that experiment.  The student phase reads its teacher from
the newest model_*.msgpack of <resumeid or exptid> (a JAX-written one
included), runs `depth.camera_num_envs` (256) envs unless --num_envs or
--debug says otherwise, starts the env state from seed + 1, and writes
vision_<step>.msgpack every 100 iterations and at the end.  `--debug`
trains 64 envs on 8 courses.  --task names the registry's TSC config
(go2, or go2_32k: 32768 envs on 256 courses).  --shard / --multihost split
the teacher's global envs over the ranks as in cli/train_bbc; the student
is not sharded (in the JAX package too the mesh reaches the teacher only)
and refuses a group of more than one rank.  TF32 is off for matrix products
and convolutions.
"""
from __future__ import annotations

import argparse
import os

import torch

from agility_tpu_torch import trace
from agility_tpu_torch.cli import registry
from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.runner_tsc import TscOnPolicyRunner
from agility_tpu_torch.learn.vision_tsc import TscVision, VisionCfg, VisionRunner

DR_FLAGS = ("randomize_base_mass", "randomize_base_com", "push_robots")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the TSC agility policy")
    p.add_argument("--task", default="go2", help="registry task: go2 or go2_32k")
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
                   help="student phase: depth-camera distillation")
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
    p.add_argument("--trace", action="store_true",
                   help="record spans over the program's layers (agility_tpu_torch/trace.py) and "
                        "write each one's ms per iteration as perf/<span>_ms at every log point")
    p.add_argument("--debug", action="store_true", help="64 envs, 8 courses")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's multi-node group (one process per card on "
                        "every host); implies --shard")
    p.add_argument("--shard", action="store_true",
                   help="split the teacher's global --num_envs over the group's ranks, one "
                        "per card (replicated parameters, data parallel)")
    return p.parse_args(argv)


def build(args):
    """The env and the runner, ready to learn: the teacher's (resumed where
    asked) or, with --use_camera, the student's on the loaded teacher; with
    --trace, tracing on from here."""
    if args.trace:
        trace.enable(args.device)
    with trace.span("build", sync=True):
        return _build(args)


def _build(args):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_tsc: --device cuda but torch sees no CUDA device")
    make_env_cfg, make_algo_cfg = registry.get(args.task)
    if args.debug:
        cfg = tsc_smoke_cfg(num_envs=64, courses=8)
    else:
        cfg = registry.apply_overrides(make_env_cfg(), seed=args.seed)
    num_envs = args.num_envs
    if num_envs is None and args.use_camera and not args.debug:
        num_envs = cfg.depth.camera_num_envs    # the reference's camera env count
    overrides = {"env.num_envs": num_envs, "obstacle.courses": args.courses}
    if args.obstacle_curriculum:
        overrides["obstacle.curriculum"] = True
    if args.randomize_start:
        overrides["env.randomize_start"] = True
    for flag in DR_FLAGS:
        if getattr(args, flag):
            overrides[f"domain_rand.{flag}"] = True
    cfg = registry.apply_overrides(cfg, **overrides)

    log_dir = os.path.join(args.log_root, args.proj_name, args.exptid)
    shard = None
    if args.use_camera:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise SystemExit("train_tsc --use_camera: the student is not sharded; run it as "
                             "one process, not under a group of several ranks")
    elif args.shard or args.multihost:
        shard, device = mesh.join(device, cfg.env.num_envs, args.multihost)
    with trace.span("build.env"):
        env = Go2AgilityEnv(cfg, device, seed=args.seed, shard=shard)
    with trace.span("build.checkpoint"):
        bbc = ckpt.load_bbc_frozen(args.bbc_path, seed=args.seed)
    with trace.span("build.trainer"):
        runner = TscOnPolicyRunner(env, bbc, make_algo_cfg(),
                                   log_dir=None if args.use_camera else log_dir, seed=args.seed)
    if args.use_camera:
        return _student(args, runner, log_dir)
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


def _student(args, teacher: TscOnPolicyRunner, log_dir: str) -> VisionRunner:
    """The depth student's runner on the teacher of <resumeid or exptid>."""
    path = ckpt.latest(os.path.join(args.log_root, args.proj_name, args.resumeid or args.exptid))
    if path:
        print(f"loading teacher from {path}")
        teacher.load(path)
    else:
        print("WARNING: no teacher checkpoint — distilling an untrained teacher")
    env, ts = teacher.env, teacher.train_state
    vision = TscVision(env, ts.ac, ts.est, teacher.alg.bbc_ac, VisionCfg(), seed=args.seed)
    env.gen.manual_seed(args.seed + 1)
    return VisionRunner(vision, env.init_state(), log_dir)


def train(runner, args):
    runner.learn(args.max_iterations, log_every=args.log_every)
    runner.save(runner.current_iteration)
    return runner


def run(args):
    return train(build(args), args)


def main(argv=None):
    try:
        run(get_args(argv))
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
