"""Interactive terminal play (counterpart of agility_tpu/cli/interactive.py):
keyboard command control and a live state panel.

The reference's IsaacGym viewer loop (bbc/legged_gym/envs/base/
base_task.py:71-236) binds W/S/A/D velocity nudges, behaviour-mode keys 1-5
and jump/locomotion height keys, and play.py:113-117 throttles to real
time.  Here the viewer is a curses panel with the same bindings: the env
batch steps in real time while env 0's telemetry (commands, base state,
foot contacts, tracking error) renders in the terminal.

Bindings (reference epsilon = 0.1 per press):
  w/s  vx +/- 0.1        a/d  vy +/- 0.1       q/e  yaw rate +/- 0.1
  1-5  behavior mode (walk/pace/trot/canter/jump)
  j/u  jump height +/- 0.05 (jump mode)
  h/n  locomotion height +/- 0.05
  space zero velocity commands     r  reset episode     x / ESC  quit

A reset reseeds the env's generator with 17 + the number of resets before
it and rebuilds the initial state; the JAX package splits PRNGKey(17) per
reset, and the two streams cannot match.
"""
from __future__ import annotations

import curses
import time

import torch

MODES = ("walk", "pace", "trot", "canter", "jump")
_EPS = 0.1
RESET_SEED = 17


def apply_key(ch, cmd, mode, jh_range, lh_range):
    """Pure key->command transition (reference base_task.py:71-113 epsilon
    semantics).  Returns (cmd, mode, action) where action is None,
    "reset", or "quit"; cmd is a fresh dict."""
    cmd = dict(cmd)
    jh_lo, jh_hi = jh_range
    lh_lo, lh_hi = lh_range
    if ch in (ord("x"), 27):
        return cmd, mode, "quit"
    if ch == ord("r"):
        return cmd, mode, "reset"
    if ch == ord("w"):
        cmd["vx"] += _EPS
    elif ch == ord("s"):
        cmd["vx"] -= _EPS
    elif ch == ord("a"):
        cmd["vy"] += _EPS
    elif ch == ord("d"):
        cmd["vy"] -= _EPS
    elif ch == ord("q"):
        cmd["wz"] += _EPS
    elif ch == ord("e"):
        cmd["wz"] -= _EPS
    elif ch == ord("j"):
        cmd["jump_h"] = min(cmd["jump_h"] + 0.05, jh_hi)
    elif ch == ord("u"):
        cmd["jump_h"] = max(cmd["jump_h"] - 0.05, jh_lo)
    elif ch == ord("h"):
        cmd["loco_h"] = min(cmd["loco_h"] + 0.05, lh_hi)
    elif ch == ord("n"):
        cmd["loco_h"] = max(cmd["loco_h"] - 0.05, lh_lo)
    elif ch == ord(" "):
        cmd["vx"] = cmd["vy"] = cmd["wz"] = 0.0
    elif ord("1") <= ch < ord("1") + len(MODES):
        mode = ch - ord("1")
    return cmd, mode, None


def _contacts_str(c):
    return " ".join(f"{leg}:{'#' if bool(v) else '.'}"
                    for leg, v in zip(("FL", "FR", "RL", "RR"), c))


def loop(scr, env, policy, state, mode_idx=2, vx=0.0, vy=0.0, wz=0.0):
    """Step `env` with `policy` under the keys read from the curses window
    `scr` (non-blocking getch) until a quit key; returns the last state."""
    from agility_tpu_torch.core import quat as qm

    N = env.num_envs
    jh_lo, jh_hi = env.cfg.commands.ranges.jump_height
    lh_lo, lh_hi = env.cfg.commands.ranges.locomotion_height
    cmd = dict(vx=vx, vy=vy, wz=wz, jump_h=0.5 * (jh_lo + jh_hi), loco_h=0.30)
    mode = int(mode_idx)
    resets = 0
    scr.nodelay(True)
    fps, t_last, steps_done = 0.0, time.time(), 0
    while True:
        cmd, mode, action = apply_key(scr.getch(), cmd, mode, (jh_lo, jh_hi), (lh_lo, lh_hi))
        if action == "quit":
            return state
        if action == "reset":
            env.gen.manual_seed(RESET_SEED + resets)
            resets += 1
            state = env.init_state()

        is_jump = MODES[mode] == "jump"
        cvec = torch.tensor([cmd["vx"], cmd["vy"], cmd["wz"], cmd["jump_h"] if is_jump else 0.0,
                             0.0 if is_jump else cmd["loco_h"]],
                            device=env.device).expand(N, 5)
        c1h = torch.nn.functional.one_hot(torch.full((N,), mode, device=env.device),
                                          len(MODES)).float()
        state = state._replace(commands=cvec, latent_c=c1h)
        t0 = time.time()
        state, out = env.step(state, policy(state.obs_buf))
        sim = state.sim
        v_local = qm.quat_rotate_inverse(sim.base_quat[:1], sim.u[:1, :3])[0].tolist()
        bp = sim.base_pos[0].tolist()
        roll, pitch, _ = (float(x[0]) for x in qm.euler_from_quat(sim.base_quat[:1]))
        contact = state.contact_filt[0].tolist()
        rew = float(out.rew[0])

        steps_done += 1
        if steps_done % 10 == 0:
            now = time.time()
            fps = 10.0 / max(now - t_last, 1e-9)
            t_last = now

        scr.erase()
        scr.addstr(0, 0, "agility_tpu_torch interactive play "
                         "(w/s a/d q/e vel, 1-5 mode, j/u h/n heights, "
                         "space zero, r reset, x quit)")
        scr.addstr(2, 0, f"mode [{mode + 1}] {MODES[mode]:<7}"
                         f"  cmd vx {cmd['vx']:+.2f}  vy {cmd['vy']:+.2f}"
                         f"  wz {cmd['wz']:+.2f}"
                         f"  jump_h {cmd['jump_h']:.2f}"
                         f"  loco_h {cmd['loco_h']:.2f}")
        scr.addstr(4, 0, f"base z {bp[2]:.3f} m   v_local "
                         f"[{v_local[0]:+.2f} {v_local[1]:+.2f} "
                         f"{v_local[2]:+.2f}] m/s   "
                         f"roll {roll:+.2f} pitch {pitch:+.2f} rad")
        scr.addstr(5, 0, f"feet {_contacts_str(contact)}   r {rew:+.4f}"
                         f"   |vx err| {abs(v_local[0] - cmd['vx']):.3f}")
        scr.addstr(6, 0, f"step {steps_done}   {fps:5.1f} steps/s "
                         f"(realtime = {1.0 / env.dt:.0f})")
        scr.refresh()

        # real-time throttle (reference play.py:113-117)
        lag = env.dt - (time.time() - t0)
        if lag > 0:
            time.sleep(lag)


def run(env, policy, state, mode_idx=2, vx=0.0, vy=0.0, wz=0.0):
    """The curses loop in the terminal; returns the last state."""
    def screen_loop(scr):
        curses.curs_set(0)
        return loop(scr, env, policy, state, mode_idx, vx, vy, wz)

    return curses.wrapper(screen_loop)
