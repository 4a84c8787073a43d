"""TSC policy networks as torch modules (counterpart of
agility_tpu/learn/networks_tsc.py): the hybrid discrete x continuous actor
with its scan encoder, and the critic.

Parameter names follow the flax modules (priv_encoder, history_encoder,
scan_encoder, actor_trunk, actor_d, actor_c, critic_trunk, critic_head,
std), so io/checkpoint.params_from_jax_tsc and params_to_jax_tsc map a
flax checkpoint leaf by leaf; networks.flax_init_ gives the modules flax's
initial values.

The hybrid action is [mode | D*C command columns]: the mode is drawn from
the discrete head's softmax as argmax(logits + Gumbel noise), as
jax.random.categorical draws it, and the commands from N(mean, std).  The
continuous log-prob sums over all D*C columns and the continuous entropy is
their mean (the reference's choices).  The JAX package's `heads_switch`
(both latents in one jitted program) is not ported: `heads` takes the
DAgger flag as a Python bool.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.plain.learn.networks import MLP, StateHistoryEncoder


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

    def hist_latent(self, obs):
        return self._latent(obs, True)

    def priv_latent(self, obs):
        return self._latent(obs, False)

    def value(self, critic_obs):
        return self.critic_head(self.critic_trunk(critic_obs))[..., 0]

    def forward(self, obs, critic_obs):
        """Both latents, the heads on the privileged latent and the value
        (the flax module's __call__, which its init traces)."""
        self.hist_latent(obs)
        d, c, std = self.heads(obs, False)
        return d, c, std, self.value(critic_obs)


def hybrid_sample(logits_d, mean_c, std, gumbel, normal) -> torch.Tensor:
    """(N, 1 + D*C) actions [mode | commands] from Gumbel noise (N, D) and
    standard normals (N, D*C)."""
    d = torch.argmax(logits_d + gumbel, dim=-1)
    c = mean_c + std * normal
    return torch.cat([d[:, None].to(mean_c.dtype), c], dim=-1)


def hybrid_log_prob(logits_d, mean_c, std, actions) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logp_d, logp_c) of actions [mode | commands]; logp_c sums over the
    full D*C head."""
    d = actions[:, 0].long()
    logp_d = torch.gather(F.log_softmax(logits_d, dim=-1), 1, d[:, None])[:, 0]
    logp_c = torch.sum(-0.5 * torch.square(actions[:, 1:] - mean_c) / std ** 2 - torch.log(std)
                       - 0.5 * math.log(2 * math.pi), dim=-1)
    return logp_d, logp_c


def hybrid_entropy(logits_d, std, mean_shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ent_d, ent_c) per row; ent_c is the mean over the D*C columns."""
    p = torch.softmax(logits_d, dim=-1)
    ent_d = -torch.sum(p * torch.log(p + 1e-20), dim=-1)
    ent_c = (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)).expand(mean_shape).mean(dim=-1)
    return ent_d, ent_c
