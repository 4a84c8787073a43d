"""TSC policy networks as torch modules (counterpart of
agility_tpu/learn/networks_tsc.py): the hybrid discrete x continuous actor
with its scan encoder, and the critic.

Parameter names follow the flax modules (priv_encoder, history_encoder,
scan_encoder, actor_trunk, actor_d, actor_c, critic_trunk, critic_head,
std), so io/checkpoint.params_from_jax_tsc maps a flax checkpoint leaf by
leaf.  The sampling, log-prob and entropy helpers serve training and are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from agility_tpu_torch.learn.networks import MLP, StateHistoryEncoder


class TscObsSlices:
    """[prop 65 | scan 132 | explicit 4 | latent 29 | hist 570]"""

    def __init__(self, n_proprio=65, n_scan=132, n_priv=4, n_priv_latent=29,
                 num_hist=10, n_auxiliary=8):
        self.n_proprio = n_proprio
        self.n_scan = n_scan
        self.n_priv = n_priv
        self.n_priv_latent = n_priv_latent
        self.num_hist = num_hist
        self.n_prop_hist = n_proprio - n_auxiliary       # 57
        o = 0
        self.prop = slice(o, o + n_proprio); o += n_proprio
        self.scan = slice(o, o + n_scan); o += n_scan
        self.explicit = slice(o, o + n_priv); o += n_priv
        self.latent = slice(o, o + n_priv_latent); o += n_priv_latent
        self.hist = slice(o, o + num_hist * self.n_prop_hist); o += num_hist * self.n_prop_hist
        self.total = o


class ScanEncoder(nn.Module):
    """Dense stack with ELU between layers and tanh after the last one."""

    def __init__(self, in_dim: int, dims: Sequence[int] = (128, 64, 32)):
        super().__init__()
        self.layers = nn.ModuleList()
        for d in dims:
            self.layers.append(nn.Linear(in_dim, d))
            in_dim = d

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            x = torch.tanh(x) if i == len(self.layers) - 1 else F.elu(x)
        return x


class ActorCriticTSC(nn.Module):
    """The actor reads [prop, scan latent, explicit, latent], the latent
    re-encoded from the privileged latent or from the proprio history; its
    discrete head picks a mode and its continuous head gives every mode's
    command block.  The critic reads the full observation."""

    def __init__(self, slices: TscObsSlices, num_actions_d: int = 3, num_actions_c: int = 6,
                 scan_encoder_dims=(128, 64, 32), actor_hidden=(512, 256, 128),
                 critic_hidden=(512, 256, 128), priv_encoder_dims=(64,),
                 init_noise_std: float = 1.0):
        super().__init__()
        s = self.slices = slices
        self.priv_encoder = MLP(s.n_priv_latent, tuple(priv_encoder_dims) + (s.n_priv_latent,),
                                activate_last=True)
        self.history_encoder = StateHistoryEncoder(s.n_prop_hist, s.num_hist, s.n_priv_latent)
        self.scan_encoder = ScanEncoder(s.n_scan, scan_encoder_dims)
        actor_in = s.n_proprio + scan_encoder_dims[-1] + s.n_priv + s.n_priv_latent
        self.actor_trunk = MLP(actor_in, actor_hidden, activate_last=True)
        self.actor_d = nn.Linear(actor_hidden[-1], num_actions_d)
        self.actor_c = nn.Linear(actor_hidden[-1], num_actions_d * num_actions_c)
        self.critic_trunk = MLP(s.total, critic_hidden, activate_last=True)
        self.critic_head = nn.Linear(critic_hidden[-1], 1)
        self.std = nn.Parameter(torch.full((num_actions_d * num_actions_c,), init_noise_std))

    def _latent(self, obs, hist_encoding: bool):
        s = self.slices
        if hist_encoding:
            return self.history_encoder(
                obs[:, s.hist].reshape(obs.shape[0], s.num_hist, s.n_prop_hist))
        return self.priv_encoder(obs[:, s.latent])

    def embed(self, obs, hist_encoding: bool = False, scandots_latent=None):
        s = self.slices
        scan = self.scan_latent(obs) if scandots_latent is None else scandots_latent
        x = torch.cat([obs[:, s.prop], scan, obs[:, s.explicit],
                       self._latent(obs, hist_encoding)], dim=-1)
        return self.actor_trunk(x)

    def heads(self, obs, hist_encoding: bool = False, scandots_latent=None):
        """Returns (logits_d (N, D), mean_c (N, D*C), std (D*C,))."""
        emb = self.embed(obs, hist_encoding, scandots_latent)
        return self.actor_d(emb), self.actor_c(emb), self.std

    def scan_latent(self, obs):
        return self.scan_encoder(obs[:, self.slices.scan])

    def value(self, critic_obs):
        return self.critic_head(self.critic_trunk(critic_obs))[..., 0]
