"""The hierarchical TSC inference step (counterpart of the teacher path of
agility_tpu/cli/play_tsc.py:act and agility_tpu/learn/ppo_tsc.py:bbc_act).

  1. the TSC estimator predicts the explicit privileged state from the
     first 57 observation columns and writes it into obs[:, explicit];
  2. the TSC heads run on the history-encoded latent; the mode is the argmax
     of the discrete head and the command block is the continuous mean;
  3. env.set_commands turns [mode, means] into BBC commands;
  4. the frozen BBC actor runs on obs_bbc with its last 11 columns replaced
     by the fresh commands (`bbc_act`, which the trainer's rollout runs
     too).  Unlike learn/policy.InferencePolicy it does not write the BBC
     estimator's prediction into the observation.
"""
from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.plain.learn import networks as nets
from benchmark.reference.plain.learn import networks_tsc as tnets


@torch.no_grad()
def bbc_act(bbc: nets.ActorCritic, obs_bbc: torch.Tensor,
            next_commands: torch.Tensor) -> torch.Tensor:
    """Frozen BBC joint actions with the high level's fresh commands."""
    obs = obs_bbc.clone()
    obs[:, -next_commands.shape[1]:] = next_commands
    return bbc.action_mean(obs, hist_encoding=True)


class TscPolicy(nn.Module):
    def __init__(self, ac: tnets.ActorCriticTSC, est: nets.Estimator, bbc: nets.ActorCritic):
        super().__init__()
        self.ac = ac
        self.est = est
        self.bbc = bbc

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """High-level hybrid action (N, 1 + D*C): [argmax mode | means]."""
        s = self.ac.slices
        obs = obs.clone()
        obs[:, s.explicit] = self.est(obs[:, :s.n_prop_hist])
        logits_d, mean_c, _ = self.ac.heads(obs, hist_encoding=True)
        d = torch.argmax(logits_d, dim=-1)
        return torch.cat([d[:, None].to(mean_c.dtype), mean_c], dim=-1)

    def bbc_act(self, obs_bbc: torch.Tensor, next_commands: torch.Tensor) -> torch.Tensor:
        return bbc_act(self.bbc, obs_bbc, next_commands)

    def step(self, env, state):
        """One hierarchical control step: act, set_commands, BBC, env.step."""
        state, next_commands = env.set_commands(state, self.act(state.obs_buf))
        return env.step(state, self.bbc_act(state.obs_bbc_buf, next_commands))


def build_tsc_policy(env_cfg, tsc_state_dicts=None, bbc_frozen=None, device="cuda",
                     seed: int = 0) -> TscPolicy:
    """The TSC teacher + frozen BBC at the env config's widths; weights from
    io/checkpoint.params_from_jax_tsc and the actor-critic of
    io/checkpoint.load_bbc_frozen or, without them, drawn at random from
    `seed`."""
    e = env_cfg.env
    slices = tnets.TscObsSlices(e.n_proprio, e.n_scan, e.n_priv, e.n_priv_latent,
                                e.history_len, e.n_auxiliary)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ac = tnets.ActorCriticTSC(slices, e.num_actions_d, e.num_actions_c)
        est = nets.Estimator(slices.n_prop_hist, e.n_priv)
        bbc = nets.ActorCritic(nets.ObsSlices(57, e.n_priv, e.n_priv_latent, e.history_len, 11),
                               num_actions=e.num_actions_bbc)
    if tsc_state_dicts is not None:
        ac.load_state_dict(tsc_state_dicts["actor_critic"])
        est.load_state_dict(tsc_state_dicts["estimator"])
    if bbc_frozen is not None:
        bbc.load_state_dict(bbc_frozen.ac)
    return TscPolicy(ac, est, bbc).to(device).eval()
