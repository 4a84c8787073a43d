"""Depth-vision student networks as torch modules (counterpart of
agility_tpu/learn/depth.py): the 58 x 87 CNN backbone, the GRU(512)
recurrent encoder emitting [32 depth latent | 2 delta-yaw | 6 obstacle-type
softmax], the frame-stack encoder, and BYOL with its depth augmentations.

Layouts, against the flax modules (io/checkpoint.params_from_jax_vision
carries the parameters across):
  * convolutions run NCHW; the flatten before the first Dense is taken from
    an NHWC view, so the flax Dense kernel's rows map without a permutation;
  * the GRU cell holds flax's parameter set: input kernels with biases for
    the r, z, n gates, recurrent kernels for r and z without biases and for
    n with one (torch.nn.GRUCell would add two biases that Adam trains);
  * BYOL's projector normalises with its stored mean and var, as flax's
    BatchNorm(use_running_average=True) does, never with batch statistics;
    the JAX trainer takes its gradient over the whole variables dict, so
    mean and var are parameters here, trained by Adam and carried by the
    EMA (a reference-side behaviour the port keeps).

Every random draw of the augmentations is handed in (`AugmentDraws`), so a
test can feed the JAX key chain's values.

A frozen plain-torch copy of agility_tpu_torch/learn/depth.py for the
benchmark's reference (it imports nothing of the program).  Departures from
the source (tsc/rsl_rl/modules/depth_backbone.py, byol.py): the GRU is
flax's cell (one bias set, see above) in place of torch.nn.GRU; BYOL's
projector normalises with stored statistics that Adam trains (above); the
gaussian blur augmentation is a 3 x 3 box blur.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.plain.learn import networks as nets


class DepthBackbone58x87(nn.Module):
    """Conv5 -> maxpool2 -> ELU -> conv3 -> ELU -> FC128 -> latent."""

    def __init__(self, output_dim: int = 32, output_activation: str = "elu",
                 image_shape: Tuple[int, int] = (58, 87)):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 32, 5)
        self.conv1 = nn.Conv2d(32, 64, 3)
        h, w = image_shape       # conv5 VALID, maxpool 2 (floor), conv3 VALID
        self.fc0 = nn.Linear(((h - 4) // 2 - 2) * ((w - 4) // 2 - 2) * 64, 128)
        self.fc1 = nn.Linear(128, output_dim)
        self.output_activation = output_activation

    def forward(self, img):                              # (..., H, W)
        lead = img.shape[:-2]
        x = img.reshape((-1, 1) + img.shape[-2:])
        x = F.elu(F.max_pool2d(self.conv0(x), 2))
        x = F.elu(self.conv1(x))
        x = x.permute(0, 2, 3, 1).flatten(1)             # HWC order, as flax
        x = self.fc1(F.elu(self.fc0(x)))
        x = torch.tanh(x) if self.output_activation == "tanh" else F.elu(x)
        return x.reshape(lead + x.shape[-1:])


class FlaxGRUCell(nn.Module):
    """flax.linen.GRUCell: r = σ(W_ir x + b_ir + W_hr h), z = σ(W_iz x + b_iz
    + W_hz h), n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n
    + z h.  The input kernels are stacked (r, z, n) in `w_i`, the recurrent
    ones in `w_h`."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_i = nn.Parameter(torch.zeros(3 * hidden, in_dim))
        self.b_i = nn.Parameter(torch.zeros(3 * hidden))
        self.w_h = nn.Parameter(torch.zeros(3 * hidden, hidden))
        self.b_hn = nn.Parameter(torch.zeros(hidden))

    @torch.no_grad()
    def flax_init_(self, gen: torch.Generator) -> None:
        """flax's GRUCell initial values: lecun-normal input kernels,
        orthogonal recurrent kernels (one per gate), zero biases."""
        H, d = self.hidden, self.w_i.shape[1]
        std = math.sqrt(1.0 / d) / nets._TRUNC_STD
        nn.init.trunc_normal_(self.w_i, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        for g in range(3):
            nn.init.orthogonal_(self.w_h[g * H:(g + 1) * H], generator=gen)
        self.b_i.zero_()
        self.b_hn.zero_()

    def forward(self, h, x):
        gi = F.linear(x, self.w_i, self.b_i)
        gh = F.linear(h, self.w_h)
        H = self.hidden
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * (gh[:, 2 * H:] + self.b_hn))
        return (1.0 - z) * n + z * h


class RecurrentDepthEncoder(nn.Module):
    """CNN + proprio-combine MLP + GRU(512) -> [latent 32 | dyaw 2 |
    obstacle-type softmax 6]."""

    def __init__(self, n_latent: int = 32, n_delta_yaw: int = 2, n_obst_type: int = 6,
                 n_proprio: int = 65, hidden: int = 512,
                 image_shape: Tuple[int, int] = (58, 87)):
        super().__init__()
        self.n_latent, self.n_delta_yaw, self.hidden = n_latent, n_delta_yaw, hidden
        self.backbone = DepthBackbone58x87(n_latent, image_shape=image_shape)
        self.combine = nets.MLP(n_latent + n_proprio, (128, n_latent))
        self.gru = FlaxGRUCell(n_latent, hidden)
        self.out = nn.Linear(hidden, n_latent + n_delta_yaw + n_obst_type)

    def forward(self, depth, prop, hidden):
        """depth (N, H, W), prop (N, n_proprio), hidden (N, 512) ->
        ([latent | dyaw | types] (N, 40), hidden)."""
        lat = self.combine(torch.cat([self.backbone(depth), prop], dim=-1))
        hidden = self.gru(hidden, lat)
        o = self.out(hidden)
        k = self.n_latent + self.n_delta_yaw
        return torch.cat([o[:, :k], torch.softmax(o[:, k:], dim=-1)], dim=-1), hidden

    def init_hidden(self, n: int):
        return torch.zeros((n, self.hidden), device=self.out.weight.device)

    def embed_image(self, depth):
        return self.backbone(depth)


def _conv1d_same(conv: nn.Conv1d, x):
    """XLA's SAME padding for a strided 1-D conv over (B, C, T): the odd
    pad goes on the right (torch's padding="same" refuses a stride > 1)."""
    k, s, L = conv.kernel_size[0], conv.stride[0], x.shape[-1]
    total = max((-(-L // s) - 1) * s + k - L, 0)
    return conv(F.pad(x, (total // 2, total - total // 2)))


class StackDepthEncoder(nn.Module):
    """Frame-stack depth encoder: per-frame CNN latents + proprio combine +
    temporal conv1d.  Registered as in the JAX package; the training path
    uses RecurrentDepthEncoder."""

    def __init__(self, n_latent: int = 32, n_proprio: int = 65, buffer_len: int = 2,
                 image_shape: Tuple[int, int] = (58, 87)):
        super().__init__()
        self.backbone = DepthBackbone58x87(n_latent, image_shape=image_shape)
        self.combine = nets.MLP(n_latent + n_proprio, (128, n_latent))
        self.conv0 = nn.Conv1d(n_latent, 16, 4, stride=2)
        self.conv1 = nn.Conv1d(16, 16, 2)
        t = -(-buffer_len // 2)                          # the strided conv's SAME length
        self.out = nn.Linear(16 * t, n_latent)

    def forward(self, depth_stack, prop):
        """depth_stack (N, buf, H, W), prop (N, n_proprio)."""
        N, B = depth_stack.shape[:2]
        feat = self.backbone(depth_stack)                               # (N, B, latent)
        feat = self.combine(torch.cat([feat, prop[:, None].expand(N, B, -1)], dim=-1))
        x = F.elu(_conv1d_same(self.conv0, feat.transpose(1, 2)))
        x = F.elu(_conv1d_same(self.conv1, x))
        return F.elu(self.out(x.transpose(1, 2).reshape(N, -1)))       # time-major, as flax


# ---------------------------------------------------------------------------
# BYOL (projection 256, hidden 4096, EMA decay 0.99)
# ---------------------------------------------------------------------------


class FixedNorm(nn.Module):
    """flax BatchNorm(use_running_average=True): (x - mean) * (rsqrt(var +
    eps) * scale) + bias with the stored mean and var, all four trainable."""

    EPS = 1e-5       # flax BatchNorm's default epsilon

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.mean = nn.Parameter(torch.zeros(dim))
        self.var = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return (x - self.mean) * (torch.rsqrt(self.var + self.EPS) * self.scale) + self.bias


class ProjectorMLP(nn.Module):
    def __init__(self, in_dim: int, projection: int = 256, hidden: int = 4096):
        super().__init__()
        self.fc0 = nn.Linear(in_dim, hidden)
        self.bn = FixedNorm(hidden)
        self.fc1 = nn.Linear(hidden, projection)

    def forward(self, x):
        return self.fc1(F.relu(self.bn(self.fc0(x))))


class BYOLNets(nn.Module):
    """Online path: backbone -> projector -> predictor; the target path uses
    the EMA'd copy's (backbone, projector)."""

    def __init__(self, n_latent: int = 32, image_shape: Tuple[int, int] = (58, 87)):
        super().__init__()
        self.backbone = DepthBackbone58x87(n_latent, image_shape=image_shape)
        self.projector = ProjectorMLP(n_latent)
        self.predictor = ProjectorMLP(256)

    def project(self, img):
        return self.projector(self.backbone(img))

    def forward(self, img):
        return self.predictor(self.project(img))


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Flax's default initial values for a depth module, drawn from `gen`:
    networks.flax_init_'s lecun-normal kernels and zero biases, the GRU's
    orthogonal recurrent kernels; FixedNorm keeps scale 1, bias 0, mean 0,
    var 1."""
    nets.flax_init_(module, gen)
    for m in module.modules():
        if isinstance(m, FlaxGRUCell):
            m.flax_init_(gen)
    return module


def byol_loss(online: BYOLNets, target: BYOLNets, img1, img2):
    """The symmetric cosine loss; the target's projections carry no gradient."""

    def cos_loss(p, z):
        p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
        return 2.0 - 2.0 * torch.sum(p * z, dim=-1)

    p1, p2 = online(img1), online(img2)
    with torch.no_grad():
        z1, z2 = target.project(img1), target.project(img2)
    return torch.mean(cos_loss(p1, z2) + cos_loss(p2, z1))


@torch.no_grad()
def byol_ema_update(online: BYOLNets, target: BYOLNets, decay: torch.Tensor) -> None:
    """target <- target * decay + online * (1 - decay), every parameter
    (mean and var included); `decay` a float32 tensor, as the JAX state's."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(t * decay + o * (1 - decay))


# ---------------------------------------------------------------------------
# depth augmentations
# ---------------------------------------------------------------------------


class AugmentDraws(NamedTuple):
    """The draws of augment_depth for B images (B, H, W), the JAX key
    split's eight streams per image."""
    apply: torch.Tensor       # (B, 4) U(0, 1): background, gaussian, dropout, blur
    box: torch.Tensor         # (B, 4) int64: patch height, width, row, column
    background: torch.Tensor  # (B, H, W) U(0, 1)
    gaussian: torch.Tensor    # (B, H, W) N(0, 1)
    dropout: torch.Tensor     # (B, H, W) U(0, 1)


def draw_augment(gen: torch.Generator, b: int, h: int, w: int) -> AugmentDraws:
    """augment_depth's draws for `b` images from `gen` (on its device)."""
    dev = gen.device
    ri = lambda lo, hi: torch.randint(lo, hi, (b,), generator=gen, device=dev)
    box = torch.stack([ri(1, h // 4), ri(1, w // 4), ri(0, 3 * h // 4), ri(0, 3 * w // 4)], -1)
    return AugmentDraws(
        apply=torch.rand((b, 4), generator=gen, device=dev), box=box,
        background=torch.rand((b, h, w), generator=gen, device=dev),
        gaussian=torch.randn((b, h, w), generator=gen, device=dev),
        dropout=torch.rand((b, h, w), generator=gen, device=dev))


def augment_depth(img, d: AugmentDraws):
    """Randomly applied depth augmentations of (B, H, W) images: a
    background-noise patch (p 0.1), gaussian noise (0.1), pixel dropout
    (0.05) and a 3 x 3 box blur as the gaussian-blur stand-in (0.1)."""
    B, H, W = img.shape
    on = lambda i, p: (d.apply[:, i] < p)[:, None, None]
    rows = torch.arange(H, device=img.device)[None, :, None]
    cols = torch.arange(W, device=img.device)[None, None, :]
    ah, aw, x0, y0 = (d.box[:, i, None, None] for i in range(4))
    mask = (rows >= x0) & (rows < x0 + ah) & (cols >= y0) & (cols < y0 + aw)
    img = torch.where(on(0, 0.1) & mask, d.background - 0.5, img)
    img = torch.where(on(1, 0.1), img + d.gaussian * 0.02, img)
    img = torch.where(on(2, 0.05), img * (d.dropout > 0.05), img)
    padded = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    blurred = 0
    for dx in range(3):
        for dy in range(3):
            blurred = blurred + padded[:, dx:dx + H, dy:dy + W]
    return torch.where(on(3, 0.1), blurred / 9.0, img)
