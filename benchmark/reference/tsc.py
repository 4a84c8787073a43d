"""The plain reference of the TSC teacher cell: the hierarchical env step
(set_commands, then the env step on the frozen BBC's actions) and the TSC
PPO training iteration of the frozen plain copy (`reference/plain`), which
imports nothing of the program and runs no hand-written kernel (K1, K2 and
K3 are their plain-torch twins there).

As the BBC's reference (reference/bbc.py): its own env from the
configuration (the obstacle courses, randomisation and model constants
worked out again from the seed), its own trainer from the seed (its own
initial weights and draws) and its own frozen BBC, read from the
checkpoint file here; from the program it takes the inputs and outputs of
the timed path, read only to judge them."""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from benchmark.harness import common
from benchmark.reference import core
from benchmark.reference.plain import checkpoint as ckpt
from benchmark.reference.plain.envs import go2_agility as agility
from benchmark.reference.plain.envs.tsc_config import Go2AgilityCfg
from benchmark.reference.plain.learn import ppo_tsc
from benchmark.reference.plain.learn.ssinfogail import metrics_to_host
from benchmark.reference.plain.physics import engine as eng

ACTION_KEYS = ("hl_actions", "bbc_actions")
MODULES = ("ac", "est")
OPTIMISERS = ("est_opt", "ac_opt", "hist_opt")
LOSS_KEYS = ("ppo/loss", "ppo/est", "ppo/surrogate", "ppo/value", "rollout/r_total")
STATE_FIELDS = ("sim.base_pos", "sim.base_quat", "sim.dof_pos", "sim.u", "obs_buf",
                "obs_bbc_buf", "disc_obs", "obs_history", "commands")


def make_cfg(overrides: Dict) -> Go2AgilityCfg:
    return core.apply_overrides(Go2AgilityCfg(), overrides)


def make_env(overrides: Dict, device, seed: int):
    return agility.Go2AgilityEnv(make_cfg(overrides), device, seed=seed)


def load_bbc_frozen(path: str) -> ppo_tsc.BBCFrozen:
    """The frozen BBC's state dicts and disc normaliser, from the file."""
    tree = ckpt.read_msgpack(path)
    sd = ckpt.params_from_jax(tree)
    norm = {k: torch.as_tensor(np.asarray(tree["disc_norm"][k], np.float32))
            for k in ("mean", "var", "count")}
    return ppo_tsc.BBCFrozen(sd["actor_critic"], sd["estimator"], sd["discriminator"], norm)


def make_trainer(env, seed: int, cfg: Dict):
    return TrainReplay(env, seed, load_bbc_frozen(cfg["reference"]["bbc_path"]))


def light_state(s) -> Dict[str, torch.Tensor]:
    """What the trainer's rollout reads of an env state (copies)."""
    return dict(obs_buf=s.obs_buf.clone(), obs_bbc_buf=s.obs_bbc_buf.clone(),
                u=s.sim.u[:, :3].clone(), cur_goal_idx=s.cur_goal_idx.clone())


def light_step(new, out) -> Dict[str, torch.Tensor]:
    """What the trainer's rollout reads of an env step's results (copies)."""
    return dict(light_state(new), rew=out.rew.clone(), reset=out.reset.clone(),
                time_out=out.time_out.clone(), reach_goal_cutoff=out.reach_goal_cutoff.clone(),
                disc_obs=out.disc_obs.clone(), terminal_disc_obs=out.terminal_disc_obs.clone())


def step(ref_env, f: Dict, with_tf32: bool = False, bbc_actions=None):
    """The reference's hierarchical step from a recorded step's input state
    and generator state: set_commands on the program's high-level actions,
    then the env step on the program's frozen-BBC actions: (new state,
    output, commands)."""
    old = core.tf32(with_tf32)
    try:
        ref_env.gen.set_state(f["gen"].cpu())
        with torch.no_grad():
            s2, nc = ref_env.set_commands(
                core.to_ref(f["state_in"], agility.AgilityState, eng.EnvState), f["hl_actions"])
            s3, out = ref_env.step(s2, f["bbc_actions"] if bbc_actions is None else bbc_actions)
        return s3, out, nc
    finally:
        core.tf32(old)


def state_gap(state, rew, ref_state, ref_rew) -> Dict:
    return core.state_gap(state, rew, ref_state, ref_rew, STATE_FIELDS)


def env_gap(ref_env, f: Dict) -> Dict:
    """The reference's step against what the program's returned."""
    s_ref, o_ref, _ = step(ref_env, f)
    return state_gap(f["state_out"], f["rew"], s_ref, o_ref.rew)


def control_env_gap(ref_env, f: Dict) -> Dict:
    """The control's reading of `env_gap`: the reference's step computed with
    TF32, in the program's place, against the float32 reference's."""
    s19, o19, _ = step(ref_env, f, True)
    s32, o32, _ = step(ref_env, f)
    return state_gap(s19, o19.rew, s32, o32.rew)


def fault_gaps(ref_env, f: Dict) -> Dict[str, Dict]:
    """The env-step faults (core.fault_gaps) read by `env_gap` against the
    reference's step from the recorded input."""
    s_ref, o_ref, _ = step(ref_env, f)
    return core.fault_gaps(f["state_in"], s_ref, o_ref.rew, state_gap)


def record(env, sampled, it: int, steps: List[Dict], full: List[Dict]):
    """Wrap the program's env set_commands and step for the check iteration
    `it`: every step's high-level actions, commands, frozen-BBC actions and
    outputs into `steps`, and whole steps (set_commands and step) at the
    `sampled` positions into `full`; returns the names of the wrapped
    attributes."""
    pending = {}

    def set_commands(state, hl_actions, noise=None):
        if (it, len(steps)) in sampled:
            pending.update(gen=env.gen.get_state(), state_in=common.clone_state(state))
        s2, nc = type(env).set_commands(env, state, hl_actions, noise)
        pending.update(hl_actions=hl_actions.clone(), next_commands=nc.clone())
        return s2, nc

    def wrapped(state, actions_bbc):
        pos = (it, len(steps))
        new, out = type(env).step(env, state, actions_bbc)
        steps.append(dict(light_step(new, out), hl_actions=pending["hl_actions"],
                          next_commands=pending["next_commands"],
                          bbc_actions=actions_bbc.clone()))
        if pos in sampled:
            full.append(common.host(dict(
                pos=pos, state_in=pending["state_in"], gen=pending["gen"],
                hl_actions=pending["hl_actions"], next_commands=pending["next_commands"],
                bbc_actions=actions_bbc.clone(), state_out=common.clone_state(new),
                rew=out.rew.clone())))
        return new, out
    env.set_commands, env.step = set_commands, wrapped
    return ("set_commands", "step")


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

class _Sim(NamedTuple):
    u: torch.Tensor


class ReplayState(NamedTuple):
    """What the TSC trainer's rollout reads of an env state."""
    obs_buf: torch.Tensor
    obs_bbc_buf: torch.Tensor
    sim: _Sim
    cur_goal_idx: torch.Tensor


class ReplayOut(NamedTuple):
    rew: torch.Tensor
    reset: torch.Tensor
    time_out: torch.Tensor
    reach_goal_cutoff: torch.Tensor
    disc_obs: torch.Tensor
    terminal_disc_obs: torch.Tensor


def _replay_state(rec: Dict, dev) -> ReplayState:
    g = lambda k: rec[k].to(dev)
    return ReplayState(g("obs_buf"), g("obs_bbc_buf"), _Sim(g("u")), g("cur_goal_idx"))


class ReplayEnv:
    """The reference env with set_commands and step replaced by the program's
    recorded results, in order; the reference's high-level and frozen-BBC
    actions are kept beside the program's for the comparison."""

    def __init__(self, env, steps: List[Dict]):
        self._env = env
        self._steps = steps
        self.t = 0
        self.hl_actions: List[torch.Tensor] = []
        self.bbc_actions: List[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def set_commands(self, state, hl_actions, noise=None):
        self.hl_actions.append(hl_actions)
        return state, self._steps[self.t]["next_commands"].to(hl_actions.device)

    def step(self, state, actions_bbc):
        rec = self._steps[self.t]
        self.t += 1
        self.bbc_actions.append(actions_bbc)
        dev = actions_bbc.device
        g = lambda k: rec[k].to(dev)
        out = ReplayOut(g("rew"), g("reset"), g("time_out"), g("reach_goal_cutoff"),
                        g("disc_obs"), g("terminal_disc_obs"))
        return _replay_state(rec, dev), out


def watch_first_steps(ts, store: Dict[str, torch.Tensor]) -> None:
    core.watch_first_steps(ts, store, MODULES, OPTIMISERS)


def snapshot_params(ts) -> Dict[str, torch.Tensor]:
    return core.snapshot_params(ts, MODULES)


class TrainReplay:
    """The reference TSC trainer, from its own initial state and its own
    frozen BBC, through the recorded iterations: its rollouts fed the
    program's recorded env results, its draws its own."""

    def __init__(self, env, seed: int, bbc: ppo_tsc.BBCFrozen):
        self.env = env
        self.alg = ppo_tsc.TscPPO(env, bbc, ppo_tsc.TscAlgoCfg(), seed=seed)
        self.ts = self.alg.init_train_state()
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.params0 = snapshot_params(self.ts)
        watch_first_steps(self.ts, self.first_grad)

    def iteration(self, it: int, rec: Dict) -> Dict:
        """One iteration on the record of the program's iteration `it`:
        {metrics (on the host), hl_actions, bbc_actions (T, N, ...)}."""
        alg = self.alg
        dev = self.env.device
        env = ReplayEnv(self.env, rec["steps"])
        alg.env = env
        try:
            self.ts, _, _, metrics = alg.train_iteration(
                self.ts, _replay_state(rec["start"], dev), rec["disc_hist"].to(dev), it)
        finally:
            alg.env = self.env
        return dict(metrics=metrics_to_host(metrics), hl_actions=torch.stack(env.hl_actions),
                    bbc_actions=torch.stack(env.bbc_actions))

