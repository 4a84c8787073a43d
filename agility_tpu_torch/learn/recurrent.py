"""Recurrent actor-critic variant (counterpart of
agility_tpu/learn/recurrent.py; reference bbc/rsl_rl/modules/
actor_critic_recurrent.py): the BBC actor-critic's MLP heads behind an LSTM
or GRU memory over the observations.  The reference registers it and no go2
task uses it; it is here so that every module of the JAX package has its
counterpart.

The cells compute what flax's do and hold their parameters in one stacked
tensor per role, so that `params_from_jax` maps a flax tree onto them:
`FlaxLSTMCell` is flax.linen.OptimizedLSTMCell (the LSTMCell maths; gates
i, f, g, o; input kernels without bias, recurrent kernels with one; carry
(c, h)), and the GRU is learn/depth.py's FlaxGRUCell (flax.linen.GRUCell;
carry h).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from agility_tpu_torch.io.checkpoint import _mlp
from agility_tpu_torch.learn import networks as nets
from agility_tpu_torch.learn.depth import FlaxGRUCell


class FlaxLSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell: i, f, o = σ(W_i· x + W_h· h + b_h·),
    g = tanh(...), c' = f c + i g, h' = o tanh(c').  The input kernels are
    stacked (i, f, g, o) in `w_i`, the recurrent ones in `w_h`, their
    biases in `b_h`."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.w_h = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.b_h = nn.Parameter(torch.zeros(4 * hidden))

    @torch.no_grad()
    def flax_init_(self, gen: torch.Generator) -> None:
        """flax's initial values: lecun-normal input kernels, orthogonal
        recurrent kernels (one per gate), zero biases."""
        H, d = self.hidden, self.w_i.shape[1]
        std = math.sqrt(1.0 / d) / nets._TRUNC_STD
        nn.init.trunc_normal_(self.w_i, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        for g in range(4):
            nn.init.orthogonal_(self.w_h[g * H:(g + 1) * H], generator=gen)
        self.b_h.zero_()

    def forward(self, carry, x):
        c, h = carry
        i, f, g, o = (F.linear(x, self.w_i) + F.linear(h, self.w_h, self.b_h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class Memory(nn.Module):
    """Single-layer recurrent memory (reference Memory :60-89)."""

    def __init__(self, in_dim: int, hidden_size: int = 256, rnn_type: str = "lstm"):
        super().__init__()
        if rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type {rnn_type!r}: 'lstm' or 'gru'")
        self.hidden_size, self.rnn_type = hidden_size, rnn_type
        self.cell = (FlaxLSTMCell(in_dim, hidden_size) if rnn_type == "lstm"
                     else FlaxGRUCell(in_dim, hidden_size))

    def forward(self, x, carry):
        """(output, new carry)."""
        if self.rnn_type == "lstm":
            carry, y = self.cell(carry, x)
            return y, carry
        h = self.cell(carry, x)
        return h, h

    def initialize_carry(self, batch: int, device="cuda"):
        z = lambda: torch.zeros((batch, self.hidden_size), device=device)
        return (z(), z()) if self.rnn_type == "lstm" else z()


class ActorCriticRecurrent(nn.Module):
    """Memory-augmented actor-critic: obs -> RNN -> MLP heads."""

    def __init__(self, num_obs: int = 671, num_critic_obs: int = None, num_actions: int = 12,
                 hidden_size: int = 256, rnn_type: str = "lstm",
                 actor_hidden: Sequence[int] = (256, 128),
                 critic_hidden: Sequence[int] = (256, 128), init_noise_std: float = 1.0):
        super().__init__()
        self.memory_a = Memory(num_obs, hidden_size, rnn_type)
        self.memory_c = Memory(num_critic_obs or num_obs, hidden_size, rnn_type)
        self.actor = nets.MLP(hidden_size, tuple(actor_hidden) + (num_actions,))
        self.critic = nets.MLP(hidden_size, tuple(critic_hidden) + (1,))
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))

    def forward(self, obs, critic_obs, carry_a, carry_c):
        """(action mean, std, value, carry_a, carry_c)."""
        ya, carry_a = self.memory_a(obs, carry_a)
        yc, carry_c = self.memory_c(critic_obs, carry_c)
        return self.actor(ya), self.std, self.critic(yc)[..., 0], carry_a, carry_c

    @torch.no_grad()
    def flax_init_(self, gen: torch.Generator) -> "ActorCriticRecurrent":
        """flax's initial values, drawn from `gen`: lecun-normal Dense
        kernels and zero biases in the heads, the cells' own (std keeps
        init_noise_std)."""
        nets.flax_init_(self, gen)
        self.memory_a.cell.flax_init_(gen)
        self.memory_c.cell.flax_init_(gen)
        return self

    def init_carries(self, batch: int, device="cuda"):
        return (self.memory_a.initialize_carry(batch, device),
                self.memory_c.initialize_carry(batch, device))


def reset_carry(carry, dones):
    """Zero recurrent state for done envs (reference reset(dones))."""
    mask = 1.0 - dones.float()[:, None]
    if isinstance(carry, tuple):
        return tuple(c * mask for c in carry)
    return carry * mask


def _t(x, transpose=False):
    x = np.asarray(x)
    return torch.as_tensor((x.T if transpose else x).copy())


def _cell(p, prefix: str):
    """A flax OptimizedLSTMCell_0 / GRUCell_0 tree as the cell's state dict."""
    if "OptimizedLSTMCell_0" in p:
        c = p["OptimizedLSTMCell_0"]
        return {f"{prefix}.w_i": torch.cat([_t(c[f"i{g}"]["kernel"], True) for g in "ifgo"]),
                f"{prefix}.w_h": torch.cat([_t(c[f"h{g}"]["kernel"], True) for g in "ifgo"]),
                f"{prefix}.b_h": torch.cat([_t(c[f"h{g}"]["bias"]) for g in "ifgo"])}
    c = p["GRUCell_0"]
    return {f"{prefix}.w_i": torch.cat([_t(c[f"i{g}"]["kernel"], True) for g in "rzn"]),
            f"{prefix}.b_i": torch.cat([_t(c[f"i{g}"]["bias"]) for g in "rzn"]),
            f"{prefix}.w_h": torch.cat([_t(c[f"h{g}"]["kernel"], True) for g in "rzn"]),
            f"{prefix}.b_hn": _t(c["hn"]["bias"])}


def params_from_jax(tree):
    """The JAX ActorCriticRecurrent's flax variables ({"params": ...}) as
    the port's ActorCriticRecurrent state dict."""
    p = tree["params"]
    sd = {"std": _t(p["std"])}
    sd.update(_cell(p["memory_a"], "memory_a.cell"))
    sd.update(_cell(p["memory_c"], "memory_c.cell"))
    sd.update(_mlp(p["actor"], "actor"))
    sd.update(_mlp(p["critic"], "critic"))
    return sd
