"""Where does the TSC teacher die on the course? (counterpart of
tools/diagnose_tsc.py)

Loads a TSC checkpoint (the newest model_<n>.msgpack in
<log_root>/<proj_name>/<exptid>/) and its frozen BBC, spawns all envs at
station 0 (no randomize_start), rolls the deterministic hierarchical stack,
and prints per-episode end states: goal index reached, how the episode
ended (course completed, timeout, other termination), each live env's
distance to its current goal, and the discrete-mode usage.

    python -m agility_tpu_torch.tools.diagnose_tsc --exptid r5 \\
        --bbc_path logs/bbc_r5/bbc_final.msgpack [--device cuda]
"""
import argparse

import numpy as np
import torch

from agility_tpu_torch.cli import play_tsc
from agility_tpu_torch.io import checkpoint as ckpt


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--proj_name", default="agility")
    p.add_argument("--exptid", default="r5")
    p.add_argument("--bbc_path", required=True)
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--courses", type=int, default=4)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--log_root", default="logs")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    # play_tsc's env: action noise, action delay and friction randomization
    # off; pushes and randomize_start are off in the config
    pargs = play_tsc.get_args(
        ["--log_root", args.log_root, "--proj_name", args.proj_name, "--exptid", args.exptid,
         "--bbc_path", args.bbc_path, "--num_envs", str(args.num_envs), "--courses",
         str(args.courses), "--seed", str(args.seed), "--device", args.device])
    print(f"teacher: {ckpt.latest(play_tsc.run_dir(pargs))}")
    env, policy, _ = play_tsc.build(pargs)
    state = env.init_state()

    end_goal = []
    end_cause = {"collision": 0, "rollpitch": 0, "leave": 0, "low_z": 0,
                 "timeout": 0, "complete": 0}
    mode_counts = np.zeros(3, int)
    for _ in range(args.steps):
        hl = policy.act(state.obs_buf)
        mode_counts += np.bincount(hl[:, 0].long().cpu().numpy(), minlength=3)
        prev = state
        state, nc = env.set_commands(state, hl)
        state, out = env.step(state, policy.bbc_act(state.obs_bbc_buf, nc))
        r = out.reset.cpu().numpy()
        if r.any():
            # the post-reset state has lost the ended episodes' goal index:
            # take it from the state before the step
            to = out.time_out.cpu().numpy()
            rg = out.reach_goal_cutoff.cpu().numpy()
            gi = prev.cur_goal_idx.cpu().numpy()
            for i in np.nonzero(r)[0]:
                end_goal.append(int(gi[i]))
                if rg[i]:
                    end_cause["complete"] += 1
                elif to[i]:
                    end_cause["timeout"] += 1
                else:
                    end_cause["other_term"] = end_cause.get("other_term", 0) + 1

    eg = np.asarray(end_goal)
    print(f"\nepisodes ended: {len(eg)};  modes used (trot/canter/jump): "
          f"{mode_counts / max(1, mode_counts.sum())}")
    print(f"end causes: {end_cause}")
    if len(eg):
        print(f"goal idx at death: mean {eg.mean():.2f}  median {np.median(eg):.0f}  "
              f"max {eg.max()}")
        hist = np.bincount(eg, minlength=26)
        for g in range(0, 26, 2):
            print(f"  goals {g:2d}-{g+1:2d}: {'#' * int(hist[g:g+2].sum())}")
    # where is everyone stuck right now?
    gi = state.cur_goal_idx.cpu().numpy()
    dist = torch.linalg.vector_norm(state.sim.base_pos[:, :2] - state.cur_goals[:, :2],
                                    dim=-1).cpu().numpy()
    print(f"\nlive envs: goal idx {gi}")
    print(f"dist to current goal: {np.array2string(dist, precision=2)}")
    print(f"base z: {np.array2string(state.sim.base_pos[:, 2].cpu().numpy(), precision=2)}")
    return dict(end_goal=eg, end_cause=end_cause, mode_counts=mode_counts)


if __name__ == "__main__":
    main()
