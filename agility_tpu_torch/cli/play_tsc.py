"""TSC evaluation entry point (counterpart of agility_tpu/cli/play_tsc.py).

Runs the hierarchical stack — TSC estimator and heads (or, with
--use_camera, the depth student: ray-cast depth -> encoder, held between
camera refreshes -> student heads) -> set_commands -> frozen BBC -> env —
on the obstacle courses and prints the course success rate, the mean goal
index reached and env-steps/s:

    python -m agility_tpu_torch.cli.play_tsc --device cuda --num_envs 6144 \\
        --courses 64 --steps 200 --checkpoint logs/agility/r5/model_12000.msgpack \\
        --bbc_path logs/bbc_r5/bbc_final.msgpack [--use_camera --vision_checkpoint
        logs/agility/vis/vision_30000.msgpack]

The checkpoints are given as files (the JAX command resolves them from
--log_root/--proj_name/--exptid).  The student's camera noise comes from a
generator seeded with seed + 2; without --vision_checkpoint it runs an
untrained student.  Float32 matrix products and convolutions run in full
float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import time

import torch

from agility_tpu_torch.cli import registry
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.policy_tsc import TscPolicy, build_tsc_policy
from agility_tpu_torch.learn.vision_tsc import StudentPolicy, TscVision, VisionCfg

WARMUP = 10  # leading control steps left out of the env-steps/s figure


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained TSC policy")
    p.add_argument("--task", default="go2_agility")
    p.add_argument("--checkpoint", default=None, help="TSC teacher checkpoint (.msgpack)")
    p.add_argument("--bbc_path", default=None, help="frozen BBC checkpoint (.msgpack)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--courses", type=int, default=8)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_camera", action="store_true",
                   help="evaluate the depth student: render depth every update_interval "
                        "steps, hold the encoder's outputs between refreshes")
    p.add_argument("--vision_checkpoint", default=None,
                   help="depth student checkpoint (vision_<step>.msgpack)")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args):
    """The play env (command noise, action delay and friction randomization
    off, as in the JAX command) and the hierarchical policy: returns (env,
    policy, device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("play_tsc: --device cuda but torch sees no CUDA device")
    cfg = registry.apply_overrides(
        registry.get(args.task)[0](),
        **{"seed": args.seed, "env.num_envs": args.num_envs, "obstacle.courses": args.courses,
           "domain_rand.randomize_action": False, "domain_rand.action_delay": False,
           "domain_rand.randomize_friction": False})
    env = Go2AgilityEnv(cfg, device, seed=args.seed)
    tsc = bbc = None
    if args.checkpoint:
        print(f"loading {args.checkpoint}")
        tsc = ckpt.params_from_jax_tsc(ckpt.read_msgpack(args.checkpoint))
    else:
        print("WARNING: no checkpoint — evaluating an untrained policy")
    if args.bbc_path:
        print(f"loading frozen BBC {args.bbc_path}")
        bbc = ckpt.load_bbc_frozen(args.bbc_path)
    else:
        print("WARNING: no BBC checkpoint — the low level is untrained")
    policy = build_tsc_policy(cfg, tsc, bbc, device, seed=args.seed)
    if args.use_camera:
        policy = student(env, policy, args)
    return env, policy, device


def student(env, teacher: TscPolicy, args) -> StudentPolicy:
    """The depth student on the teacher's estimator and the frozen BBC, its
    encoder and heads from --vision_checkpoint."""
    vision = TscVision(env, teacher.ac, teacher.est, teacher.bbc, VisionCfg(), seed=args.seed)
    vts = vision.init_train_state()
    if args.vision_checkpoint:
        print(f"loading student {args.vision_checkpoint}")
        sd = ckpt.params_from_jax_vision(ckpt.read_msgpack(args.vision_checkpoint))
        vts.enc.load_state_dict(sd["encoder"])
        vts.actor.load_state_dict(sd["actor_critic"])
    else:
        print("WARNING: no vision checkpoint — evaluating an untrained student")
    gen = torch.Generator(device=env.device).manual_seed(args.seed + 2)
    return StudentPolicy(vision, vts.enc.eval(), vts.actor.eval(), gen)


def run(args) -> dict:
    """Build the env and policy, roll `args.steps` control steps and print
    the statistics.  Returns the env, the policy, the final AgilityState,
    env-steps/s, the steps taken (init_state's zero-action step included)
    and the episode counts."""
    env, policy, device = build(args)
    N = args.num_envs
    state = env.init_state()
    successes = torch.zeros((), dtype=torch.long, device=device)
    episodes = torch.zeros_like(successes)
    speed = torch.zeros((), device=device)
    t0 = None
    for i in range(args.steps):
        if i == min(WARMUP, args.steps - 1):
            _sync(device)
            t0 = time.perf_counter()
        state, out = policy.step(env, state)
        successes += torch.sum(out.reach_goal_cutoff & out.reset)
        episodes += torch.sum(out.reset)
        speed += torch.linalg.vector_norm(state.sim.u[:, :2], dim=-1).mean()
    _sync(device)
    timed = args.steps - min(WARMUP, args.steps - 1)
    steps_per_s = N * timed / (time.perf_counter() - t0)

    successes, episodes = int(successes), int(episodes)
    print(f"episodes: {episodes}  course completions: {successes}  "
          f"success rate: {successes / max(1, episodes):.3f}")
    print(f"mean goal index at end: {float(state.cur_goal_idx.float().mean()):.2f}")
    print(f"mean base speed: {float(speed) / args.steps:.3f} m/s")
    print(f"env-steps/s {steps_per_s:.1f} over {timed} steps x {N} envs on {device}")
    return dict(env=env, policy=policy, state=state, env_steps_per_s=steps_per_s,
                steps=args.steps + 1,
                episodes=episodes, completions=successes)


def main(argv=None):
    run(get_args(argv))


if __name__ == "__main__":
    main()
