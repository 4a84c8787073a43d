"""The plain reference of the BBC cells: the env step and the SSInfoGAIL
training iteration of the frozen plain copy (`reference/plain`), which
imports nothing of the program and runs no hand-written kernel (K1 and K2
are their plain-torch twins there).

It builds its own env from the configuration (terrain, domain
randomisation and model constants worked out again from the config's seed)
and its own trainer from the seed (its own initial weights, expert preload
and draws).  What it takes from the program are the inputs and outputs the
program's timed path produced, read only to judge them:

  * env steps: a state the program's env was handed, its generator state,
    the actions, and what the program's step returned;
  * training: each env step's outputs, which the reference's own rollout
    is fed in place of stepping physics (the env step is judged on its own
    at sampled steps), the program's actions, losses, first gradients and
    parameters.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from benchmark.reference.plain.envs import go2_locomotion as loco
from benchmark.reference.plain.envs.config import Go2LocomotionCfg
from benchmark.reference.plain.learn import ssinfogail as sg
from benchmark.reference.plain.learn.policy import build_policy
from benchmark.reference.plain.physics import engine as eng
from benchmark.harness import common
from benchmark.reference import core
from benchmark.reference.plain import checkpoint as ckpt


def make_cfg(overrides: Dict) -> Go2LocomotionCfg:
    return core.apply_overrides(Go2LocomotionCfg(), overrides)


def make_env(overrides: Dict, device, seed: int):
    return loco.Go2LocomotionEnv(make_cfg(overrides), device, seed=seed)


def make_trainer(env, seed: int, cfg: Dict):
    return TrainReplay(env, seed)


def light_state(s) -> Dict[str, torch.Tensor]:
    """What the trainer's rollout reads of an env state (copies)."""
    return dict(obs_buf=s.obs_buf.clone(), latent_eps=s.latent_eps.clone(),
                latent_c=s.latent_c.clone(), u=s.sim.u[:, :3].clone())


def light_step(new, out) -> Dict[str, torch.Tensor]:
    """What the trainer's rollout reads of an env step's results (copies)."""
    return dict(light_state(new), rew=out.rew.clone(), reset=out.reset.clone(),
                time_out=out.time_out.clone(), disc_obs=out.disc_obs.clone(),
                terminal_disc_obs=out.terminal_disc_obs.clone())


STATE_FIELDS = ("sim.base_pos", "sim.base_quat", "sim.dof_pos", "sim.u", "obs_buf", "disc_obs",
                "obs_history", "episode_sums")


def step(ref_env, state_in, gen_state, actions, with_tf32: bool = False):
    """The reference env's step from a program's input state and generator
    state: (new state, step output)."""
    old = core.tf32(with_tf32)
    try:
        ref_env.gen.set_state(gen_state.cpu())
        with torch.no_grad():
            return ref_env.step(core.to_ref(state_in, loco.LocoState, eng.EnvState), actions)
    finally:
        core.tf32(old)


def state_gap(state, rew, ref_state, ref_rew) -> Dict:
    return core.state_gap(state, rew, ref_state, ref_rew, STATE_FIELDS)


def env_gap(ref_env, f: Dict) -> Dict:
    """The reference env's step from a recorded step's input state,
    generator state and actions, against what the program's step returned."""
    s_ref, o_ref = step(ref_env, f["state_in"], f["gen"], f["actions"])
    return state_gap(f["state_out"], f["rew"], s_ref, o_ref.rew)


def control_env_gap(ref_env, f: Dict) -> Dict:
    """The control's reading of `env_gap`: the reference's step computed with
    TF32, in the program's place, against the float32 reference's."""
    s19, o19 = step(ref_env, f["state_in"], f["gen"], f["actions"], True)
    s32, o32 = step(ref_env, f["state_in"], f["gen"], f["actions"])
    return state_gap(s19, o19.rew, s32, o32.rew)


def fault_gaps(ref_env, f: Dict) -> Dict[str, Dict]:
    """The env-step faults (core.fault_gaps) read by `env_gap` against the
    reference's step from the recorded input."""
    s_ref, o_ref = step(ref_env, f["state_in"], f["gen"], f["actions"])
    return core.fault_gaps(f["state_in"], s_ref, o_ref.rew, state_gap)


def record(env, sampled, it: int, steps: List[Dict], full: List[Dict]):
    """Wrap the program's env step for the check iteration `it`: every
    step's outputs into `steps`, and whole steps at the `sampled` positions
    into `full`; returns the names of the wrapped attributes."""
    def wrapped(state, actions):
        pos = (it, len(steps))
        if pos in sampled:
            gen, s_in = env.gen.get_state(), common.clone_state(state)
        new, out = type(env).step(env, state, actions)
        steps.append(dict(light_step(new, out), actions=actions.clone()))
        if pos in sampled:
            full.append(common.host(dict(pos=pos, state_in=s_in, gen=gen, actions=actions.clone(),
                                         state_out=common.clone_state(new),
                                         rew=out.rew.clone())))
        return new, out
    env.step = wrapped
    return ("step",)


def control_step(ref_env, policy, state_in, gen_state, with_tf32: bool = False):
    """A whole control step of the reference: its policy's actions on the
    input state's observation, then its env's step: (actions, new state,
    step output)."""
    old = core.tf32(with_tf32)
    try:
        actions = policy(state_in.obs_buf)
    finally:
        core.tf32(old)
    return (actions,) + tuple(step(ref_env, state_in, gen_state, actions, with_tf32))


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

class _Sim(NamedTuple):
    u: torch.Tensor


class ReplayState(NamedTuple):
    """What the trainer's rollout reads of an env state."""
    obs_buf: torch.Tensor
    latent_eps: torch.Tensor
    latent_c: torch.Tensor
    sim: _Sim
    prior_parameters: Optional[torch.Tensor] = None


class ReplayOut(NamedTuple):
    rew: torch.Tensor
    reset: torch.Tensor
    time_out: torch.Tensor
    disc_obs: torch.Tensor
    terminal_disc_obs: torch.Tensor


class ReplayEnv:
    """The reference env with its step replaced by the program's recorded
    step outputs, in order; the reference's actions are kept beside the
    program's for the comparison."""

    def __init__(self, env, steps: List[Dict]):
        self._env = env
        self._steps = steps
        self.t = 0
        self.actions: List[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, actions):
        rec = self._steps[self.t]
        self.t += 1
        self.actions.append(actions)
        dev = actions.device
        g = lambda k: rec[k].to(dev)
        nxt = ReplayState(g("obs_buf"), g("latent_eps"), g("latent_c"), _Sim(g("u")))
        out = ReplayOut(g("rew"), g("reset"), g("time_out"), g("disc_obs"),
                        g("terminal_disc_obs"))
        return nxt, out


ACTION_KEYS = ("actions",)
MODULES = ("ac", "est", "disc")
OPTIMISERS = ("est_opt", "ac_opt", "hist_opt", "disc_opt_d", "disc_opt_qe", "disc_opt_qc")


def watch_first_steps(ts, store: Dict[str, torch.Tensor]) -> None:
    core.watch_first_steps(ts, store, MODULES, OPTIMISERS)


def snapshot_params(ts) -> Dict[str, torch.Tensor]:
    return core.snapshot_params(ts, MODULES)


class TrainReplay:
    """The reference trainer, from its own initial state, through the
    recorded iterations: its rollouts fed the program's recorded env
    outputs, its draws its own."""

    def __init__(self, env, seed: int):
        self.env = env
        self.alg = sg.SSInfoGAIL(env, sg.AlgoCfg(), seed=seed)
        self.ts = self.alg.init_train_state()
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.params0 = snapshot_params(self.ts)
        watch_first_steps(self.ts, self.first_grad)

    def iteration(self, it: int, rec: Dict) -> Dict:
        """One iteration on the record of the program's iteration `it`:
        {metrics (on the host), actions (T, N, A)}."""
        alg, ts = self.alg, self.ts
        dev = self.env.device
        env = ReplayEnv(self.env, rec["steps"])
        alg.env = env
        s0 = rec["start"]
        es = ReplayState(s0["obs_buf"].to(dev), s0["latent_eps"].to(dev),
                         s0["latent_c"].to(dev), _Sim(s0["u"].to(dev)))
        disc_hist = rec["disc_hist"].to(dev)
        try:
            ts, es, disc_hist, metrics = alg.train_iteration(ts, es, disc_hist, it)
        finally:
            alg.env = self.env
        self.ts = ts
        return dict(metrics=sg.metrics_to_host(metrics), actions=torch.stack(env.actions))


LOSS_KEYS = ("ppo/loss", "ppo/est", "ppo/surrogate", "ppo/value", "disc/loss", "disc/disc",
             "rollout/r_total")


# ----------------------------------------------------------------------------
# play
# ----------------------------------------------------------------------------

def play_policy(checkpoint: str, cfg, device):
    """The played policy, its weights read from the checkpoint file here."""
    return build_policy(cfg, ckpt.params_from_jax(ckpt.read_msgpack(checkpoint)), device)

