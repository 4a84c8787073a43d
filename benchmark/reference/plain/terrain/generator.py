"""Procedural terrain generation (host-side numpy, build time).

The port's own copy of agility_tpu/terrain/generator.py.

Our own implementation of the sub-terrain recipes the reference gets from
isaacgym `terrain_utils` (bbc/legged_gym/utils/terrain.py:81-120): a grid of
num_rows x num_cols cells, each stamped with a randomized terrain type drawn
from `terrain_proportions` at a difficulty from `difficulties`, surrounded by
a flat border.  Heights are quantized to `vertical_scale` steps (like the
reference's int16 raw field) and returned in meters.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from benchmark.reference.plain.envs.config import TerrainCfg


class TerrainData(NamedTuple):
    height: np.ndarray        # (H, W) float32 meters
    hscale: float
    origin: Tuple[float, float]   # world xy of node (0, 0) (= -border)
    env_origins: np.ndarray   # (num_rows, num_cols, 3) spawn origins


def _quantize(h, vscale):
    return np.round(h / vscale).astype(np.int32).astype(np.float32) * vscale


def pyramid_slope(n, hscale, slope, platform=3.0):
    """Linear pyramid rising (slope>0) or sinking toward a flat center
    platform."""
    half = n // 2
    x = np.abs(np.arange(n) - half)[:, None]
    y = np.abs(np.arange(n) - half)[None, :]
    d = np.maximum(x, y).astype(np.float32) * hscale     # distance to center
    dmax = half * hscale
    h = slope * (dmax - d)
    plat = platform / 2.0
    h = np.where(d < plat, slope * (dmax - plat), h)
    return h


def random_uniform(n, hscale, min_h=-0.05, max_h=0.05, step=0.005, down_scale=0.2, rng=None):
    rng = rng or np.random.default_rng()
    nd = max(2, int(n * hscale / down_scale))
    levels = np.arange(min_h, max_h + 1e-9, step)
    coarse = rng.choice(levels, size=(nd, nd))
    # bilinear upsample to (n, n)
    xi = np.linspace(0, nd - 1, n)
    x0 = np.clip(np.floor(xi).astype(int), 0, nd - 2)
    fx = xi - x0
    rows = coarse[x0] * (1 - fx)[:, None] + coarse[x0 + 1] * fx[:, None]
    h = rows[:, x0] * (1 - fx)[None, :] + rows[:, x0 + 1] * fx[None, :]
    return h.astype(np.float32)


def pyramid_stairs(n, hscale, step_width=0.31, step_height=0.18, platform=3.0):
    half = n // 2
    x = np.abs(np.arange(n) - half)[:, None]
    y = np.abs(np.arange(n) - half)[None, :]
    d = np.maximum(x, y).astype(np.float32) * hscale
    dmax = half * hscale
    k = np.floor((dmax - d) / step_width)
    kplat = np.floor((dmax - platform / 2.0) / step_width)
    k = np.minimum(k, kplat)
    return (k * step_height).astype(np.float32)


def discrete_obstacles(n, hscale, max_h=0.15, min_size=1.0, max_size=2.0, num_rects=20, platform=3.0, rng=None):
    rng = rng or np.random.default_rng()
    h = np.zeros((n, n), np.float32)
    heights = np.array([-max_h, -max_h / 2, max_h / 2, max_h])
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / hscale)
        l = int(rng.uniform(min_size, max_size) / hscale)
        x = rng.integers(0, max(1, n - w))
        y = rng.integers(0, max(1, n - l))
        h[x : x + w, y : y + l] = rng.choice(heights)
    p = int(platform / hscale / 2)
    c = n // 2
    h[c - p : c + p, c - p : c + p] = 0.0
    return h


def stepping_stones(n, hscale, stone_size=1.0, stone_dist=0.1, max_h=0.0, platform=4.0, depth=-1.0, rng=None):
    rng = rng or np.random.default_rng()
    h = np.full((n, n), depth, np.float32)
    ss = max(1, int(stone_size / hscale))
    sd = int(stone_dist / hscale)
    pitch = ss + sd
    for x0 in range(0, n, pitch):
        for y0 in range(0, n, pitch):
            h[x0 : x0 + ss, y0 : y0 + ss] = rng.uniform(-max_h, max_h) if max_h > 0 else 0.0
    p = int(platform / hscale / 2)
    c = n // 2
    h[c - p : c + p, c - p : c + p] = 0.0
    return h


def gap(n, hscale, gap_size=1.0, platform=3.0):
    h = np.zeros((n, n), np.float32)
    c = n // 2
    p2 = int(platform / hscale) // 2
    g = int(gap_size / hscale)
    outer = p2 + g
    h[c - outer : c + outer, c - outer : c + outer] = -5.0
    h[c - p2 : c + p2, c - p2 : c + p2] = 0.0
    return h


def pit(n, hscale, depth=1.0, platform=4.0):
    h = np.zeros((n, n), np.float32)
    c = n // 2
    p2 = int(platform / hscale / 2)
    h[c - p2 : c + p2, c - p2 : c + p2] = -depth
    return h


def make_cell(choice: float, difficulty: float, cfg: TerrainCfg, rng) -> np.ndarray:
    """One sub-terrain cell following the reference's type thresholds
    (terrain.py:83-120)."""
    n = int(cfg.terrain_width / cfg.horizontal_scale)
    hs = cfg.horizontal_scale
    props = np.cumsum(cfg.terrain_proportions)
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    disc_h = 0.05 + difficulty * 0.2
    stone_size = 1.5 * (1.05 - difficulty)
    stone_dist = 0.05 if difficulty == 0 else 0.1

    if choice < props[0]:
        if choice < props[0] / 2:
            slope = -slope
        h = pyramid_slope(n, hs, slope)
    elif choice < props[1]:
        h = pyramid_slope(n, hs, slope) + random_uniform(n, hs, rng=rng)
    elif len(props) > 3 and choice < props[3]:
        sh = -step_height if choice < props[2] else step_height
        h = pyramid_stairs(n, hs, step_height=sh)
    elif len(props) > 4 and choice < props[4]:
        h = discrete_obstacles(n, hs, max_h=disc_h, rng=rng)
    else:
        h = stepping_stones(n, hs, stone_size=stone_size, stone_dist=stone_dist, rng=rng)
    return _quantize(h, cfg.vertical_scale)


def generate(cfg: TerrainCfg, seed: int = 0) -> TerrainData:
    rng = np.random.default_rng(seed)
    n = int(cfg.terrain_width / cfg.horizontal_scale)
    border = int(cfg.border_size / cfg.horizontal_scale)
    H = cfg.num_rows * n + 2 * border
    W = cfg.num_cols * n + 2 * border
    height = np.zeros((H, W), np.float32)
    env_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

    if cfg.mesh_type == "plane":
        origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
        # spread origins on a grid for plane terrain too
        for i in range(cfg.num_rows):
            for j in range(cfg.num_cols):
                origins[i, j] = [(i + 0.5) * cfg.terrain_length, (j + 0.5) * cfg.terrain_width, 0.0]
        return TerrainData(
            height=height, hscale=cfg.horizontal_scale,
            origin=(-cfg.border_size, -cfg.border_size), env_origins=origins)

    for i in range(cfg.num_rows):
        for j in range(cfg.num_cols):
            if cfg.curriculum:
                difficulty = i / cfg.num_rows
                choice = j / cfg.num_cols + 0.001
            else:
                choice = rng.uniform(0, 1)
                difficulty = rng.choice(np.asarray(cfg.difficulties))
            cell = make_cell(choice, difficulty, cfg, rng)
            x0, y0 = border + i * n, border + j * n
            height[x0 : x0 + n, y0 : y0 + n] = cell
            # spawn at cell center, z = max height in the central 2x2 m
            cx = (i + 0.5) * cfg.terrain_length
            cy = (j + 0.5) * cfg.terrain_width
            m = int(1.0 / cfg.horizontal_scale)
            zc = np.max(cell[n // 2 - m : n // 2 + m, n // 2 - m : n // 2 + m])
            env_origins[i, j] = [cx, cy, zc]

    return TerrainData(
        height=height, hscale=cfg.horizontal_scale,
        origin=(-cfg.border_size, -cfg.border_size), env_origins=env_origins)


def assign_env_origins(td: TerrainData, num_envs: int, cfg: TerrainCfg, seed: int = 0) -> np.ndarray:
    """Distribute envs over terrain cells (reference _get_env_origins,
    legged_robot.py:1109-1136: random column, level capped by
    max_init_terrain_level when no curriculum)."""
    rng = np.random.default_rng(seed + 1)
    max_level = cfg.num_rows if not cfg.curriculum else cfg.max_init_terrain_level
    rows = rng.integers(0, max(1, min(max_level, cfg.num_rows)), num_envs)
    cols = np.floor(np.arange(num_envs) / num_envs * cfg.num_cols).astype(int)
    return td.env_origins[rows, cols]
