"""Deterministic inference policy (counterpart of agility_tpu/learn/runner.py:
OnPolicyRunner.get_inference_policy).

The estimator predicts the explicit privileged state from proprioception
and writes it into obs[:, explicit]; the actor then runs on the
history-encoded latent.
"""
from __future__ import annotations

import torch
from torch import nn

from agility_tpu_torch import trace
from agility_tpu_torch.learn import networks as nets


class InferencePolicy(nn.Module):
    def __init__(self, ac: nets.ActorCritic, est: nets.Estimator):
        super().__init__()
        self.ac = ac
        self.est = est

    @trace.spanned("policy")
    @torch.no_grad()
    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        s = self.ac.slices
        obs = obs.clone()
        obs[:, s.explicit] = self.est(obs[:, s.prop])
        return self.ac.action_mean(obs, hist_encoding=True)


def build_policy(env_cfg, state_dicts=None, device="cuda", seed: int = 0) -> InferencePolicy:
    """The BBC inference policy at the env config's widths; weights from
    `state_dicts` (io/checkpoint.params_from_jax) or, without them, drawn
    at random from `seed`."""
    e = env_cfg.env
    slices = nets.ObsSlices(e.num_prop, e.num_explicit, e.num_latent, e.history_len,
                            e.num_command)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ac = nets.ActorCritic(slices, num_actions=e.num_actions)
        est = nets.Estimator(e.num_prop, e.num_explicit)
    if state_dicts is not None:
        ac.load_state_dict(state_dicts["actor_critic"])
        est.load_state_dict(state_dicts["estimator"])
    return InferencePolicy(ac, est).to(device).eval()
