"""Per-env terrain windows (counterpart of agility_tpu/physics/patch.py:
extract_batch and measure_scandots_batch, gather path).

Once per control step a (P, P) window of the height grid around each robot
is gathered and folded with the env's movable-layer weights; every substep
then samples contact heights and normals from it (soa.patch_sample_hn).
Each env step also measures the 132-point scandot observation.  These are
the plain versions of kernels K2 (kernels/terrain_window.py) and K3
(kernels/scandots.py).  On the GPU a window is a plain index gather: the
JAX package's banded one-hot matrix-unit contraction was a TPU workaround
for slow gathers and is not carried over.

The grid coordinates divide by a device tensor holding hscale rather than
by a Python float: CUDA torch turns division by a host scalar into a
multiplication by its reciprocal, which can move a window origin by one
cell away from the kernels' (and the CPU's) true division.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from agility_tpu_torch.physics.heightfield import HeightGrid


class Patch(NamedTuple):
    values: torch.Tensor   # (N, P, P) floor heights [m], layers and lever folded in
    x0: torch.Tensor       # (N,) int64 grid x-index of patch node (0, 0)
    y0: torch.Tensor       # (N,)
    hscale: float
    origin: tuple
    ceil: Optional[torch.Tensor] = None   # (N, P, P) ceiling heights, layers folded


def grid_index(grid: HeightGrid, x, y):
    """Fractional grid coordinates ((x - ox) / hscale, (y - oy) / hscale)."""
    # a fill on the device, not a copy from the host, which would wait for it
    hs = torch.full((), grid.hscale, dtype=x.dtype, device=x.device)
    return (x - grid.origin[0]) / hs, (y - grid.origin[1]) / hs


def window_origin(grid: HeightGrid, centers_xy: torch.Tensor, size: int):
    """Per-env window origin (x0, y0): the nearest node to the centre less
    size // 2, clamped into the grid.  torch.round rounds half to even, as
    jnp.round does."""
    H, W = grid.height.shape
    gx, gy = grid_index(grid, centers_xy[:, 0], centers_xy[:, 1])
    x0 = torch.clamp(torch.round(gx).long() - size // 2, 0, max(H - size, 0))
    y0 = torch.clamp(torch.round(gy).long() - size // 2, 0, max(W - size, 0))
    return x0, y0


def _fold_layers(vals, tags, lw):
    """vals + lw[l] where tag == l + 1, one add per layer as the reference."""
    for l in range(lw.shape[-1]):
        vals = vals + torch.where(tags == l + 1, lw[:, l, None, None], 0.0)
    return vals


def extract_batch(grid: HeightGrid, centers_xy: torch.Tensor, size: int,
                  weights: Optional[torch.Tensor] = None) -> Patch:
    """(N, size, size) windows centred at world `centers_xy` (N, 2), float32.
    weights (N, L) or None: the floor gains lever * weights[:, -1] and the
    layer offsets weights[:, :-1] (layer 0 is the static ground); the
    ceiling, where the grid has one, gains the same layer offsets."""
    H, W = grid.height.shape
    size = min(size, H, W)
    x0, y0 = window_origin(grid, centers_xy, size)
    ar = torch.arange(size, device=centers_xy.device)
    ix, iy = (x0[:, None] + ar)[:, :, None], (y0[:, None] + ar)[:, None, :]
    vals = grid.height[ix, iy]
    lw = weights
    if grid.lever is not None and weights is not None:
        vals = vals + grid.lever[ix, iy] * weights[:, -1, None, None]
        lw = weights[:, :-1]
    fold = lw is not None and lw.shape[-1] > 0
    if grid.layer_id is not None and fold:
        vals = _fold_layers(vals, grid.layer_id[ix, iy], lw)
    ceil = None
    if grid.ceiling is not None:
        ceil = grid.ceiling[ix, iy]
        if grid.ceiling_layer is not None and fold:
            ceil = _fold_layers(ceil, grid.ceiling_layer[ix, iy], lw)
    return Patch(values=vals, x0=x0, y0=y0, hscale=grid.hscale, origin=grid.origin,
                 ceil=ceil)


def scandot_nodes(grid: HeightGrid, centers_xy, size: int, px, py):
    """Grid (row, col) of each scandot's floor node: the point clipped into
    the env's size-window at its origin, floored.  The row clips relative
    to the window and the column in absolute grid units, exactly as the
    JAX gather path; both stay below the window's last row/column, so the
    +x/+y neighbours lie inside it."""
    H, W = grid.height.shape
    size = min(size, H, W)
    x0, y0 = window_origin(grid, centers_xy, size)
    gx, gy = grid_index(grid, px, py)
    gx = torch.clamp(gx - x0[:, None].to(px.dtype), 0.0, size - 1.001)
    gy = torch.clamp(gy, y0[:, None].to(py.dtype), (y0 + size)[:, None].to(py.dtype) - 1.001)
    return x0[:, None] + torch.floor(gx).long(), torch.floor(gy).long()


def measure_scandots_batch(grid: HeightGrid, centers_xy: torch.Tensor, size: int,
                           weights: Optional[torch.Tensor], px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """Scandot heights (N, K) float32 at world points px/py (N, K): the
    conservative min(node, +x, +y) floor height at each point's floor node
    in the size-window around `centers_xy` (N, 2).

    The floor is folded in bfloat16, as the JAX package's scandot path:
    height and lever rounded to bf16, weights rounded to bf16, and every
    multiply and add rounded to bf16.  Only the three nodes each point reads
    are gathered; the JAX package's (P, P) window and one-hot selection give
    the same values."""
    r, c = scandot_nodes(grid, centers_xy, size, px, py)
    r = torch.stack([r, r + 1, r], -1)                     # (N, K, 3): node, +x, +y
    c = torch.stack([c, c, c + 1], -1)
    bf = torch.bfloat16
    vals = grid.height[r, c].to(bf)
    lw = weights
    if grid.lever is not None and weights is not None:
        vals = vals + grid.lever[r, c].to(bf) * weights[:, -1, None, None].to(bf)
        lw = weights[:, :-1]
    if grid.layer_id is not None and lw is not None and lw.shape[-1] > 0:
        vals = _fold_layers(vals, grid.layer_id[r, c], lw.to(bf))
    return vals.amin(dim=-1).float()
