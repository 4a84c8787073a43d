"""Trajectory-level diagnosis of a trained BBC checkpoint (counterpart of
tools/diagnose_gait.py).

Steps a trained policy in a chosen mode and prints per-step aggregates that
separate three failure hypotheses for a too-fast gait:

  * physics exploit (contact solver injects energy at speed): kinetic
    energy rises while feet are airborne-bouncing; |v| grows across hops.
  * falling-off-world artifact (harness measures through fall resets): |v|
    ramps linearly at ~g between resets, z monotonically drops, episode
    ends by timeout/fall rather than contact.
  * measurement bug: sim velocities stay sane but the report is wrong.

    python -m agility_tpu_torch.tools.diagnose_gait --checkpoint logs/bbc_r5/bbc_final.msgpack \\
        --mode trot --vx 1.0 --steps 300 --num_envs 8 [--mocap_dir D] [--device cuda]

Without --mocap_dir the env's clips are the synthetic ones.
"""
import argparse

import numpy as np
import torch

from agility_tpu_torch.cli import play_bbc
from agility_tpu_torch.core import quat as qm


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--mode", default="trot")
    p.add_argument("--vx", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--num_envs", type=int, default=8)
    p.add_argument("--mocap_dir", default=None)
    p.add_argument("--dump", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    env, policy, _, hold = play_bbc.build(play_bbc.get_args(
        ["--task", "go2_locomotion", "--checkpoint", args.checkpoint, "--num_envs",
         str(args.num_envs), "--mode", args.mode, "--vx", str(args.vx), "--device", args.device]
        + (["--mocap_dir", args.mocap_dir] if args.mocap_dir else [])))
    state = env.init_state()
    N = args.num_envs

    # mass for kinetic-energy estimate (base translation only — enough for
    # the exploit-vs-fall signature)
    m_tot = float(env.mc.link_mass.sum())

    traj = {k: [] for k in ("z", "vx_w", "vz_w", "speed", "contact", "reset",
                            "vx_local", "dof_vel_max", "tau_max")}
    for _ in range(args.steps):
        state = hold(state)
        state, out = env.step(state, policy(state.obs_buf))
        sim = state.sim
        v = sim.u[:, :3]
        traj["z"].append(sim.base_pos[:, 2])
        traj["vx_w"].append(v[:, 0])
        traj["vz_w"].append(v[:, 2])
        traj["speed"].append(torch.linalg.vector_norm(v, dim=-1))
        traj["vx_local"].append(qm.quat_rotate_inverse(sim.base_quat, v)[:, 0])
        traj["contact"].append(state.contact_filt.sum(-1))
        traj["reset"].append(out.reset)
        traj["dof_vel_max"].append(sim.u[:, 6:].abs().amax(-1))
        traj["tau_max"].append(state.torques_org.abs().amax(-1))
    traj = {k: torch.stack(v).cpu().numpy() for k, v in traj.items()}      # (T, N)

    T = args.steps
    resets = traj["reset"].sum(axis=0)
    print(f"mode={args.mode} cmd vx={args.vx} N={N} T={T}  total_mass={m_tot:.2f} kg")
    print(f"resets/env over rollout: {resets}")
    print(f"|vx_local - cmd| mean {np.abs(traj['vx_local'] - args.vx).mean():.3f}")
    print(f"speed: mean {traj['speed'].mean():.2f}  max {traj['speed'].max():.2f} m/s")
    print(f"z:     mean {traj['z'].mean():.2f}  min {traj['z'].min():.2f}  "
          f"max {traj['z'].max():.2f} m")
    print(f"contact count mean {traj['contact'].mean():.2f} / 4")
    print(f"dof_vel max {traj['dof_vel_max'].max():.1f} rad/s  "
          f"tau max {traj['tau_max'].max():.1f} Nm")

    # per-env worst-window report: where does speed peak, and what does z do
    # around it?
    for n in range(min(N, 4)):
        t_pk = int(traj["speed"][:, n].argmax())
        lo, hi = max(0, t_pk - 5), min(T, t_pk + 5)
        print(f"\nenv {n}: peak speed {traj['speed'][t_pk, n]:.2f} m/s at t={t_pk}")
        for t in range(lo, hi):
            print(f"  t={t:4d} z={traj['z'][t, n]:+7.2f} vz={traj['vz_w'][t, n]:+7.2f} "
                  f"vx={traj['vx_w'][t, n]:+7.2f} |v|={traj['speed'][t, n]:6.2f} "
                  f"nc={int(traj['contact'][t, n])} reset={int(traj['reset'][t, n])}")

    if args.dump:
        np.savez(args.dump, **traj)
        print(f"\ntrajectory written to {args.dump}")
    return traj


if __name__ == "__main__":
    main()
