"""Policy / value / estimator / discriminator networks as torch modules
(counterpart of agility_tpu/learn/networks.py).

Parameter names follow the flax modules (priv_encoder, history_encoder,
actor_trunk, actor_head, critic_trunk, critic_head, std; the estimator's
MLP; the discriminator's trunk and heads), so io/checkpoint.params_from_jax
and params_to_jax map a flax checkpoint leaf by leaf.

`flax_init_` gives a module flax's initial values (PyTorch's defaults,
kaiming-uniform kernels and uniform biases, are a different start):
lecun-normal kernels truncated at 2 sigma, sigma = sqrt(1 / fan_in) / 0.8796
(the truncation's variance correction), zero biases; the discriminator's
logit head is U(-1, 1) and the policy's `std` starts at init_noise_std.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    """Dense stack with ELU between layers (and after the last one when
    `activate_last`)."""

    def __init__(self, in_dim: int, dims: Sequence[int], activate_last: bool = False):
        super().__init__()
        self.layers = nn.ModuleList()
        for d in dims:
            self.layers.append(nn.Linear(in_dim, d))
            in_dim = d
        self.activate_last = activate_last

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.activate_last:
                x = F.elu(x)
        return x


class StateHistoryEncoder(nn.Module):
    """Per-step projection -> temporal 1D conv stack -> latent (tsteps = 10)."""

    def __init__(self, num_prop: int, tsteps: int = 10, output_size: int = 29,
                 channels: int = 10):
        super().__init__()
        if tsteps != 10:
            raise ValueError("the BBC history encoder is ported for tsteps = 10")
        ch = channels
        self.proj = nn.Linear(num_prop, 3 * ch)
        self.conv0 = nn.Conv1d(3 * ch, 2 * ch, kernel_size=4, stride=2)
        self.conv1 = nn.Conv1d(2 * ch, ch, kernel_size=2, stride=1)
        self.out = nn.Linear(3 * ch, output_size)   # 3 time steps x ch after the convs

    def forward(self, hist):                          # (B, T, num_prop)
        x = F.elu(self.proj(hist)).transpose(1, 2)    # (B, C, T)
        x = F.elu(self.conv1(F.elu(self.conv0(x))))   # (B, ch, 3)
        x = x.transpose(1, 2).flatten(1)              # time-major flatten, as flax
        return F.elu(self.out(x))


class ObsSlices:
    """Actor-obs layout: [prop | explicit | latent | hist | cmd]."""

    def __init__(self, num_prop=57, num_explicit=4, num_latent=29, num_hist=10,
                 num_command=11):
        self.num_prop = num_prop
        self.num_explicit = num_explicit
        self.num_latent = num_latent
        self.num_hist = num_hist
        self.num_command = num_command
        o = 0
        self.prop = slice(o, o + num_prop); o += num_prop
        self.explicit = slice(o, o + num_explicit); o += num_explicit
        self.latent = slice(o, o + num_latent); o += num_latent
        self.hist = slice(o, o + num_hist * num_prop); o += num_hist * num_prop
        self.command = slice(o, o + num_command); o += num_command
        self.total = o


class ActorCritic(nn.Module):
    """BBC actor-critic: the actor reads [prop, explicit, latent, command],
    the latent re-encoded from the privileged latent or from the proprio
    history; the critic reads the full observation."""

    def __init__(self, slices: ObsSlices, num_actions: int = 12,
                 actor_hidden=(512, 256, 128), critic_hidden=(512, 256, 128),
                 priv_encoder_dims=(64,), init_noise_std: float = 1.0):
        super().__init__()
        s = self.slices = slices
        self.priv_encoder = MLP(s.num_latent, tuple(priv_encoder_dims) + (s.num_latent,),
                                activate_last=True)
        self.history_encoder = StateHistoryEncoder(s.num_prop, s.num_hist, s.num_latent)
        actor_in = s.num_prop + s.num_explicit + s.num_latent + s.num_command
        self.actor_trunk = MLP(actor_in, actor_hidden, activate_last=True)
        self.actor_head = nn.Linear(actor_hidden[-1], num_actions)
        self.critic_trunk = MLP(s.total, critic_hidden, activate_last=True)
        self.critic_head = nn.Linear(critic_hidden[-1], 1)
        self.std = nn.Parameter(torch.full((num_actions,), init_noise_std))

    def _latent(self, obs, hist_encoding: bool):
        s = self.slices
        if hist_encoding:
            return self.history_encoder(
                obs[:, s.hist].reshape(obs.shape[0], s.num_hist, s.num_prop))
        return self.priv_encoder(obs[:, s.latent])

    def action_mean(self, obs, hist_encoding: bool = False):
        s = self.slices
        x = torch.cat([obs[:, s.prop], obs[:, s.explicit], self._latent(obs, hist_encoding),
                       obs[:, s.command]], dim=-1)
        return self.actor_head(self.actor_trunk(x))

    def value(self, critic_obs):
        return self.critic_head(self.critic_trunk(critic_obs))[..., 0]

    def hist_latent(self, obs):
        return self._latent(obs, True)

    def priv_latent(self, obs):
        return self._latent(obs, False)


class Estimator(nn.Module):
    """prop (57) -> explicit privileged state (4)."""

    def __init__(self, num_prop: int = 57, output_dim: int = 4, hidden=(128, 64)):
        super().__init__()
        self.mlp = MLP(num_prop, tuple(hidden) + (output_dim,))

    def forward(self, prop):
        return self.mlp(prop)


class Discriminator(nn.Module):
    """SSInfoGAIL discriminator: a shared ReLU trunk and three heads, the
    real/fake logit, the eps encoder and the mode classifier (a softmax
    clipped below at 1e-20)."""

    def __init__(self, in_dim: int, dim_c: int = 5, hidden=(512, 256)):
        super().__init__()
        self.trunk = nn.ModuleList()
        for d in hidden:
            self.trunk.append(nn.Linear(in_dim, d))
            in_dim = d
        self.head_logit = nn.Linear(in_dim, 1)
        self.head_eps = nn.Linear(in_dim, 1)
        self.head_classifier = nn.Linear(in_dim, dim_c)

    def forward(self, x):
        for layer in self.trunk:
            x = F.relu(layer(x))
        c = torch.softmax(self.head_classifier(x), dim=-1)
        return self.head_logit(x), self.head_eps(x), torch.clamp(c, min=1e-20)


# ---------------------------------------------------------------------------


_TRUNC_STD = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's default initial values, in place, drawn from `gen` (on the
    parameters' device): lecun-normal kernels (fan_in = in for a Dense,
    kernel size x in for a Conv, 1-D or 2-D), truncated at 2 sigma, and zero biases;
    a Discriminator's logit kernel U(-1, 1); ActorCritic.std keeps its
    init_noise_std."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            nn.init.zeros_(m.bias)
    for m in module.modules():
        if isinstance(m, Discriminator):
            nn.init.uniform_(m.head_logit.weight, -1.0, 1.0, generator=gen)
    return module


def gaussian_log_prob(mean, std, actions):
    var = std ** 2
    return torch.sum(-0.5 * torch.square(actions - mean) / var - torch.log(std)
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def gaussian_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std), dim=-1)


class RunningNormalizer:
    """Running mean / population variance of features (Welford merge of
    whole batches), count starting at 1e-4; `normalize` clips at +-10."""

    CLIP = 10.0

    def __init__(self, dim: int, device="cuda"):
        self.mean = torch.zeros(dim, device=device)
        self.var = torch.ones(dim, device=device)
        self.count = torch.tensor(1e-4, device=device)

    def update(self, batch: torch.Tensor) -> None:
        bmean = batch.mean(dim=0)
        bvar = batch.var(dim=0, correction=0)
        bcount = batch.shape[0]
        delta = bmean - self.mean
        tot = self.count + bcount
        self.mean = self.mean + delta * bcount / tot
        m2 = self.var * self.count + bvar * bcount + torch.square(delta) * self.count * bcount / tot
        self.var = m2 / tot
        self.count = tot

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        out = (x - self.mean) / torch.sqrt(self.var + 1e-8)
        return torch.clamp(out, -self.CLIP, self.CLIP)

    def state_dict(self):
        return {"mean": self.mean, "var": self.var, "count": self.count}

    def load_state_dict(self, sd) -> None:
        dev = self.mean.device
        self.mean, self.var, self.count = (torch.as_tensor(sd[k], dtype=torch.float32).to(dev)
                                           for k in ("mean", "var", "count"))
