"""Heightfield terrain queries (counterpart of agility_tpu/physics/heightfield.py).

The world is a regular height grid sampled bilinearly on the device.  The
TSC obstacle-course world adds optional surfaces: movable layer tags
(`layer_id`, the bar beam and tire sill), the seesaw `lever` grid, and an
overhead `ceiling` surface (tunnel roof, tire top ring) with its own layer
tags.  Per-env `weights` (N, L) fold them in at sample time, in the JAX
package's order: the lever times weights[:, -1], then the layer offsets
from weights[:, :-1], where layer 0 is the static ground.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NO_CEILING = 100.0   # sentinel ceiling height [m] for open-sky cells


class HeightGrid(NamedTuple):
    height: torch.Tensor      # (H, W) meters
    hscale: float             # grid spacing [m]
    origin: tuple             # (x, y) world position of grid node (0, 0)
    layer_id: Optional[torch.Tensor] = None       # (H, W) int8: 0 ground, l > 0 movable
    lever: Optional[torch.Tensor] = None          # (H, W) f32 seesaw lever arm [m]
    ceiling: Optional[torch.Tensor] = None        # (H, W) f32, NO_CEILING = open sky
    ceiling_layer: Optional[torch.Tensor] = None  # (H, W) int8


def flat_grid(size: float = 1.0, device="cuda") -> HeightGrid:
    """A flat plane: a degenerate 2 x 2 zero grid."""
    return HeightGrid(height=torch.zeros((2, 2), device=device), hscale=float(size),
                      origin=(-float(size), -float(size)))


def from_numpy(height_m: np.ndarray, hscale: float, origin_xy=(0.0, 0.0),
               device="cuda", layer_id=None, lever=None, ceiling=None,
               ceiling_layer=None) -> HeightGrid:
    o = np.asarray(origin_xy, np.float32)   # f32-rounded, as the JAX grid stores it
    t = lambda x, dt: None if x is None else torch.as_tensor(np.asarray(x, dt), device=device)
    return HeightGrid(
        height=t(height_m, np.float32), hscale=float(hscale),
        origin=(float(o[0]), float(o[1])), layer_id=t(layer_id, np.int8),
        lever=t(lever, np.float32), ceiling=t(ceiling, np.float32),
        ceiling_layer=t(ceiling_layer, np.int8))


def _grid_coords(g: HeightGrid, x, y):
    H, W = g.height.shape
    gx = torch.clamp((x - g.origin[0]) / g.hscale, 0.0, H - 1.001)
    gy = torch.clamp((y - g.origin[1]) / g.hscale, 0.0, W - 1.001)
    return gx, gy


def _col(weights, i, like):
    """Per-env weight column i, shaped to broadcast against `like` (N, ...)."""
    return weights[:, i].reshape((-1,) + (1,) * (like.dim() - 1))


def _layer_offset(tags, xi, yi, lw, like):
    """w[tag] with w = [0, lw...] at integer nodes: the movable-layer offset."""
    lid = tags[xi, yi]
    off = torch.zeros_like(like)
    for l in range(lw.shape[-1]):
        off = torch.where(lid == l + 1, _col(lw, l, like), off)
    return off


def _node(g: HeightGrid, xi, yi, weights):
    """Effective floor height at integer nodes: gather + seesaw tilt
    (lever * weights[-1]) + movable-layer offset."""
    h = g.height[xi, yi]
    if weights is None:
        return h
    lw = weights
    if g.lever is not None:
        h = h + g.lever[xi, yi] * _col(weights, -1, h)
        lw = weights[:, :-1]
    if g.layer_id is not None and lw.shape[-1] > 0:
        h = h + _layer_offset(g.layer_id, xi, yi, lw, h)
    return h


def _cnode(g: HeightGrid, xi, yi, weights):
    """Effective ceiling height at integer nodes (NO_CEILING = open sky)."""
    h = g.ceiling[xi, yi]
    if weights is None:
        return h
    lw = weights[:, :-1] if g.lever is not None else weights
    if g.ceiling_layer is not None and lw.shape[-1] > 0:
        h = h + _layer_offset(g.ceiling_layer, xi, yi, lw, h)
    return h


def _cell(g: HeightGrid, x, y):
    """Integer node (x0, y0) of the cell under world (x, y) and the grid
    coordinates (gx, gy)."""
    gx, gy = _grid_coords(g, x, y)
    return torch.floor(gx).long(), torch.floor(gy).long(), gx, gy


def _bilinear(node, g: HeightGrid, x, y, weights):
    x0, y0, gx, gy = _cell(g, x, y)
    fx, fy = gx - x0, gy - y0
    return (node(g, x0, y0, weights) * (1 - fx) * (1 - fy)
            + node(g, x0 + 1, y0, weights) * fx * (1 - fy)
            + node(g, x0, y0 + 1, weights) * (1 - fx) * fy
            + node(g, x0 + 1, y0 + 1, weights) * fx * fy)


def sample_height(g: HeightGrid, x, y, weights=None):
    """Bilinear height at world (x, y); x/y broadcast to any shape with a
    leading env axis when `weights` (N, L) is given."""
    return _bilinear(_node, g, x, y, weights)


def sample_ceiling(g: HeightGrid, x, y, weights=None):
    """Bilinear ceiling height at world (x, y); requires g.ceiling."""
    return _bilinear(_cnode, g, x, y, weights)


def sample_lever(g: HeightGrid, x, y):
    """Bilinear raw seesaw lever arm [m] at world (x, y); requires g.lever
    (the env turns foot normal forces into plank torque with it)."""
    return _bilinear(lambda g, xi, yi, _: g.lever[xi, yi], g, x, y, None)


def on_lever(g: HeightGrid, x, y):
    """True where any of the 4 surrounding nodes is a seesaw plank cell
    (lever != 0)."""
    x0, y0, _, _ = _cell(g, x, y)
    lv = g.lever
    return ((lv[x0, y0] != 0) | (lv[x0 + 1, y0] != 0)
            | (lv[x0, y0 + 1] != 0) | (lv[x0 + 1, y0 + 1] != 0))


def sample_height_nearest(g: HeightGrid, x, y, weights=None):
    """Nearest-node height (torch.round rounds half to even, as jnp.round)."""
    gx, gy = _grid_coords(g, x, y)
    return _node(g, torch.round(gx).long(), torch.round(gy).long(), weights)


def sample_height_min3(g: HeightGrid, x, y, weights=None):
    """Conservative floor-node height: min of the cell node and its +x/+y
    neighbours (the reference's scandot lookup)."""
    x0, y0, _, _ = _cell(g, x, y)
    hm = torch.minimum(_node(g, x0, y0, weights), _node(g, x0 + 1, y0, weights))
    return torch.minimum(hm, _node(g, x0, y0 + 1, weights))


def sample_normal(g: HeightGrid, x, y, weights=None, eps: float = None):
    """Unit surface normal from central differences of the bilinear surface
    (with the env's `weights` folded in, as sample_height)."""
    e = g.hscale if eps is None else eps
    h = lambda xx, yy: sample_height(g, xx, yy, weights)
    dhdx = (h(x + e, y) - h(x - e, y)) / (2 * e)
    dhdy = (h(x, y + e) - h(x, y - e)) / (2 * e)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
