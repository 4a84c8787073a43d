"""Dog-agility obstacle course generation (host-side numpy, build time).

The port's own copy of agility_tpu/terrain/obstacle.py, with `lever_arm`,
which the env evaluates every step, in torch.

Our implementation of the reference's Obstacle generator
(tsc/legged_gym/utils/obstacle.py): per-course, the six obstacle types
(bar_jump, frame, poles, seesaw, tire_jump, tunnel) are shuffled onto an
S-shaped six-station layout (cfg frame_pos/frame_ang), rasterized into a
heightfield with per-obstacle yaw/position noise, goal waypoints (4 per
obstacle + repeated final goals), x-edge masks for the feet_edge penalty,
and 2 m border walls.

TPU-native deviations from the reference:
* A configurable number of *unique* courses is generated and shared across
  envs (the reference rasterizes one course per env into a single giant
  grid); per-env diversity beyond course layout comes from the randomized
  bar/tire heights.
* Movable obstacle parts (bar beam, tire aperture — DOF-driven actors in
  IsaacGym, tsc/.../legged_robot.py:1370-1427) become heightfield *layers*:
  cells tagged bar/tire get a per-env height weight added at sample time,
  which also makes the height curriculum (:917-957) a pure array update.
* The seesaw's 1-DOF passive plank (revolute DOF, stiffness 0, damping
  U(1,10), tsc/.../legged_robot.py:1414-1427) is rasterized FLAT at pivot
  height with a signed *lever* grid; effective height at sample time is
  `pivot + lever * theta` where theta is a per-env plank angle integrated
  by the env from foot contact torques (go2_agility.py).
* Overhangs (the tunnel roof and the tire's top ring — URDF collision
  meshes in the reference, loaded at tsc/.../legged_robot.py:1260-1289)
  live in a second *ceiling* heightfield surface (lowest overhead solid z)
  sampled by both the contact engine and the depth ray-caster.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

OBST_TYPES = ("bar_jump", "frame", "poles", "seesaw", "tire_jump", "tunnel")
LAYER_NONE, LAYER_BAR, LAYER_TIRE = 0, 1, 2

NO_CEILING = 100.0   # open-sky sentinel (must match heightfield.NO_CEILING)

# 1-DOF seesaw plank (reference: revolute DOF with PD + passive tilt,
# tsc legged_robot.py:1370-1427).  The plank is rasterized FLAT at the pivot
# height with a signed lever grid; the per-env tilt angle multiplies the
# lever at sample time (h = pivot + lever * theta), so plank dynamics are a
# per-env scalar integrated by the env.
SEESAW_PIVOT_H = 0.26
SEESAW_HALF_LEN = 1.5
SEESAW_WIDTH = 0.6
SEESAW_THETA_MAX = SEESAW_PIVOT_H / SEESAW_HALF_LEN   # end touches ground
SEESAW_THETA_REST = SEESAW_THETA_MAX                  # approach (-x) end down
SEESAW_INERTIA = 9.0   # plank about pivot [kg m^2] (~12 kg x 3 m board)


def lever_arm(seesaw_pose, x, y):
    """Analytic signed seesaw lever arm [m] at world (x, y): the signed
    along-plank offset where (x, y) lies on the surviving plank, else 0.

    seesaw_pose: (..., 5) [pivot_x, pivot_y, yaw, t_lo, t_hi]; x/y
    broadcastable against seesaw_pose[..., 0]."""
    px, py, yaw = seesaw_pose[..., 0], seesaw_pose[..., 1], seesaw_pose[..., 2]
    t_lo, t_hi = seesaw_pose[..., 3], seesaw_pose[..., 4]
    c, s = torch.cos(yaw), torch.sin(yaw)
    dx, dy = x - px, y - py
    along = c * dx + s * dy
    perp = -s * dx + c * dy
    on = ((along >= t_lo) & (along <= t_hi)
          & (torch.abs(along) <= SEESAW_HALF_LEN)
          & (torch.abs(perp) <= SEESAW_WIDTH / 2))
    return torch.where(on, along, 0.0)


@dataclasses.dataclass(frozen=True)
class ObstacleCfg:
    # tsc/legged_gym/envs/base/legged_robot_config.py:155-228
    proportions: tuple = (0.2, 0.15, 0.2, 0.15, 0.2, 0.1)
    bar_jump_range: tuple = (0.05, 0.20)
    tire_jump_range: tuple = (0.40, 0.55)
    curriculum: bool = False
    curr_step: float = 0.01
    curr_threshold: float = 0.8
    bar_jump_init_range: tuple = (0.05, 0.10)
    tire_jump_init_range: tuple = (0.40, 0.45)
    bar_jump_max_range: tuple = (0.05, 0.3)
    tire_jump_max_range: tuple = (0.40, 0.65)
    horizontal_scale: float = 0.05
    vertical_scale: float = 0.005
    border_size: float = 5.0
    border_height: float = 2.0
    env_length: float = 7.0
    env_width: float = 10.0
    robot_org: tuple = (4.5, 0.5)
    num_goals: int = 4
    last_goal_repeat: int = 2
    num_obst_per_env: int = 6
    random_x: tuple = (-0.25, 0.25)
    random_y: tuple = (-0.15, 0.15)
    random_yaw_deg: tuple = (-5.0, 5.0)
    # S-shaped course stations (config frame_pos/frame_ang :226-228)
    frame_pos: tuple = (
        ((5.5, 1.0), (5.5, 5.0)), ((5.5, 5.0), (5.5, 9.0)), ((3.5, 9.0), (3.5, 5.0)),
        ((3.5, 5.0), (3.5, 1.0)), ((1.5, 1.0), (1.5, 5.0)), ((1.5, 5.0), (1.5, 9.0)))
    frame_ang_deg: tuple = (90, 90, -90, -90, 90, 90)
    measured_points_x: tuple = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1)
    measured_points_y: tuple = (-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
    # static per-env scandot grid perturbation: each point offset by the sum
    # of two U(-v, v) draws at build time (reference _init_height_points,
    # tsc legged_robot.py:1674-1699; reference default 0.0)
    measure_horizontal_noise: float = 0.0
    courses: int = 64      # unique course layouts (ours; reference: per-env)


class CourseWorld(NamedTuple):
    height: np.ndarray       # (H, W) f32 meters (canonical: movable parts at 0)
    layer_id: np.ndarray     # (H, W) int8: 0 none / 1 bar / 2 tire
    x_edge: np.ndarray       # (H, W) bool
    ceil: np.ndarray         # (H, W) f32 lowest overhead solid z (NO_CEILING = sky)
    ceil_layer: np.ndarray   # (H, W) int8 (ceiling z += weight[layer])
    lever: np.ndarray        # (H, W) f32 signed seesaw lever arm [m] (0 = rigid)
    hscale: float
    origin: tuple            # world xy of node (0, 0)
    course_origins: np.ndarray   # (courses, 3) world cell origin
    goals: np.ndarray        # (courses, n_goals_total, 3) world, canonical z
    goal_layer: np.ndarray   # (courses, n_goals_total) int8 (z += weight[layer])
    obst_types: np.ndarray   # (courses, 6) int obstacle type per station
    obst_yaws: np.ndarray    # (courses, 6)
    robot_org: np.ndarray    # (courses, 3) start position (world)
    seesaw_pose: np.ndarray  # (courses, 5) seesaw pivot world (x, y), yaw,
    #                          and the along-plank extent [t_lo, t_hi]
    #                          actually present in the raster (a later
    #                          station's stamp can truncate a plank end).
    #                          The analytic lever-arm source: the rasterized
    #                          `lever` grid is its nearest-neighbor image;
    #                          the env samples the analytic form clipped to
    #                          the extent — no grid gather on the hot path

    @property
    def n_goals_total(self):
        return self.goals.shape[1]


class _Cell:
    """One course cell being rasterized (local pixel coords)."""

    def __init__(self, cfg: ObstacleCfg):
        self.cfg = cfg
        n_x = int(cfg.env_length / cfg.horizontal_scale)
        n_y = int(cfg.env_width / cfg.horizontal_scale)
        self.h = np.zeros((n_x, n_y), np.float32)
        self.layer = np.zeros((n_x, n_y), np.int8)
        self.edge = np.zeros((n_x, n_y), bool)
        self.ceil = np.full((n_x, n_y), NO_CEILING, np.float32)
        self.ceil_layer = np.zeros((n_x, n_y), np.int8)
        self.lever = np.zeros((n_x, n_y), np.float32)

    def px(self, v):
        return int(round(v / self.cfg.horizontal_scale))


def _rect(a, x0, y0, lx, ly, val):
    a[max(0, x0) : max(0, x0 + lx), max(0, y0) : max(0, y0 + ly)] = val


def _paint(a, x0, y0, block):
    """Write a 2D block at (x0, y0), clipping to the array bounds."""
    H, W = a.shape
    bx, by = block.shape
    sx0, sy0 = max(0, -x0), max(0, -y0)
    dx0, dy0 = max(0, x0), max(0, y0)
    dx1, dy1 = min(H, x0 + bx), min(W, y0 + by)
    if dx1 <= dx0 or dy1 <= dy0:
        return
    a[dx0:dx1, dy0:dy1] = block[sx0 : sx0 + (dx1 - dx0), sy0 : sy0 + (dy1 - dy0)]


def _rot_into(dst: _Cell, src: _Cell, center_px, yaw):
    """Stamp src raster into dst, rotated by yaw about center_px: for every
    dst pixel near the obstacle, inverse-rotate to source coords and copy
    where the source is non-empty (the reference's polygon-fill inverse
    mapping, obstacle.py:137-179, generalized to the full stencil)."""
    H, W = dst.h.shape
    src_occ = ((src.h != 0) | (src.layer != 0) | src.edge
               | (src.ceil != NO_CEILING) | (src.lever != 0))
    xs, ys = np.nonzero(src_occ)
    if len(xs) == 0:
        return
    # bounding box of the source stencil, dilated by rotation
    cx, cy = center_px
    r = int(np.ceil(np.hypot((xs - cx), (ys - cy)).max())) + 2
    gx, gy = np.meshgrid(
        np.arange(max(0, cx - r), min(H, cx + r)),
        np.arange(max(0, cy - r), min(W, cy + r)), indexing="ij")
    c, s = np.cos(yaw), np.sin(yaw)
    # inverse rotation of dst coords into src coords
    sx = np.round(c * (gx - cx) + s * (gy - cy) + cx).astype(int)
    sy = np.round(-s * (gx - cx) + c * (gy - cy) + cy).astype(int)
    valid = (sx >= 0) & (sx < src.h.shape[0]) & (sy >= 0) & (sy < src.h.shape[1])
    sxc = np.clip(sx, 0, src.h.shape[0] - 1)
    syc = np.clip(sy, 0, src.h.shape[1] - 1)
    hv = np.where(valid, src.h[sxc, syc], 0.0)
    lv = np.where(valid, src.layer[sxc, syc], 0)
    ev = np.where(valid, src.edge[sxc, syc], False)
    cv = np.where(valid, src.ceil[sxc, syc], NO_CEILING)
    clv = np.where(valid, src.ceil_layer[sxc, syc], 0)
    lvv = np.where(valid, src.lever[sxc, syc], 0.0)
    occ = (hv != 0) | (lv != 0) | ev | (cv != NO_CEILING) | (lvv != 0)
    dst.h[gx, gy] = np.where(occ, hv, dst.h[gx, gy])
    dst.layer[gx, gy] = np.where(occ, lv, dst.layer[gx, gy])
    dst.edge[gx, gy] = np.where(occ, ev, dst.edge[gx, gy])
    dst.ceil[gx, gy] = np.where(occ, cv, dst.ceil[gx, gy])
    dst.ceil_layer[gx, gy] = np.where(occ, clv, dst.ceil_layer[gx, gy])
    dst.lever[gx, gy] = np.where(occ, lvv, dst.lever[gx, gy])


# ---------------------------------------------------------------------------
# per-obstacle rasterizers (local cell coords, obstacle at `pos`)
# ---------------------------------------------------------------------------


def _bar_jump(cell: _Cell, pos):
    # beam 1.2 wide x 0.2 long at joint height (movable), posts 2.04/0.42
    cfg = cell.cfg
    px, py = cell.px(pos[0]), cell.px(pos[1])
    w1, l1 = cell.px(1.2), cell.px(0.2)
    w2, l2 = cell.px(2.04), cell.px(0.5)
    _rect(cell.h, px - l2 // 2, py - w2 // 2, l2, (w2 - w1) // 2, 0.42)
    _rect(cell.h, px - l2 // 2, py + w1 // 2, l2, (w2 - w1) // 2, 0.42)
    _rect(cell.layer, px - l1 // 2, py - w1 // 2, l1, w1, LAYER_BAR)
    cell.edge[px - l2 // 2 : px + l2 // 2, py - w2 // 2 : py + w2 // 2] |= (
        (cell.h[px - l2 // 2 : px + l2 // 2, py - w2 // 2 : py + w2 // 2] != 0)
        | (cell.layer[px - l2 // 2 : px + l2 // 2, py - w2 // 2 : py + w2 // 2] != 0))
    g = np.zeros((4, 3))
    g[0] = [pos[0] - 1.8, pos[1], 0.3]
    g[1] = [pos[0] - 0.9, pos[1], 0.3]
    g[2] = [pos[0], pos[1], 0.3]          # z += bar height via goal_layer
    g[3] = [pos[0] + 0.9, pos[1], 0.3]
    return g, np.array([0, 0, LAYER_BAR, 0], np.int8)


def _a_frame(cell: _Cell, pos, height=0.333, length=1.4625, width=0.6):
    cfg = cell.cfg
    px, py = cell.px(pos[0]), cell.px(pos[1])
    L, Wd = cell.px(length), cell.px(width)
    xs = np.arange(px - L, px + L + 1)
    ramp = height * (1.0 - np.abs(xs - px) / L)
    _paint(cell.h, px - L, py - Wd // 2,
           np.broadcast_to(ramp[:, None], (len(xs), Wd + 1)).copy())
    _rect(cell.edge, px - L, py - Wd // 2, 2 * L + 1, 2, True)
    _rect(cell.edge, px - L, py + Wd // 2 - 1, 2 * L + 1, 2, True)
    g = np.zeros((4, 3))
    g[0] = [pos[0] - length - 0.7, pos[1], 0.3]
    g[1] = [pos[0] - length, pos[1], 0.3]
    g[2] = [pos[0], pos[1], height + 0.3]
    g[3] = [pos[0] + length, pos[1], 0.3]
    return g, np.zeros(4, np.int8)


def _poles(cell: _Cell, pos):
    cfg = cell.cfg
    r = cell.px(0.1)
    h = 1.0
    spacing = cell.px(1.0)
    px, py = cell.px(pos[0]), cell.px(pos[1])
    for i in range(4):
        _rect(cell.h, px - r + i * spacing, py - r, 2 * r, 2 * r, h)
    g = np.zeros((4, 3))
    for i in range(4):
        yb = -0.5 if i % 2 == 0 else 0.5
        g[i] = [pos[0] + i * 1.0, pos[1] + yb, 0.3]
    return g, np.zeros(4, np.int8)


def _seesaw(cell: _Cell, pos):
    """1-DOF plank: rasterized FLAT at pivot height with a signed lever grid
    so effective height = pivot + lever * theta(t); theta is per-env plank
    state integrated by the env (reference: passive revolute DOF,
    tsc legged_robot.py:1414-1427; static heightfield view obstacle.py:376-432).
    Goals match the reference seesaw (goal_x_step 0.7, z bias 0.3)."""
    px, py = cell.px(pos[0]), cell.px(pos[1])
    L, Wd = cell.px(SEESAW_HALF_LEN), cell.px(SEESAW_WIDTH)
    xs = np.arange(px - L, px + L + 1)
    lever = (xs - px) * cell.cfg.horizontal_scale          # signed arm [m]
    _paint(cell.h, px - L, py - Wd // 2,
           np.full((len(xs), Wd + 1), SEESAW_PIVOT_H, np.float32))
    _paint(cell.lever, px - L, py - Wd // 2,
           np.broadcast_to(lever[:, None], (len(xs), Wd + 1)).copy())
    _rect(cell.edge, px - L, py - Wd // 2, 2 * L + 1, 2, True)
    _rect(cell.edge, px - L, py + Wd // 2 - 1, 2 * L + 1, 2, True)
    g = np.zeros((4, 3))
    g[0] = [pos[0] - SEESAW_HALF_LEN - 0.7, pos[1], 0.3]
    g[1] = [pos[0] - SEESAW_HALF_LEN, pos[1], 0.3]
    g[2] = [pos[0], pos[1], SEESAW_PIVOT_H + 0.3]
    g[3] = [pos[0] + SEESAW_HALF_LEN, pos[1], 0.3]
    return g, np.zeros(4, np.int8)


def _tire_jump(cell: _Cell, pos):
    # tire aperture: circular sill profile at joint height (movable) between
    # tall side frames (obstacle.py:434-481)
    cfg = cell.cfg
    px, py = cell.px(pos[0]), cell.px(pos[1])
    r = cell.px(0.4)
    w = cell.px(1.5)
    l1, l2 = cell.px(0.2), cell.px(0.6)
    ys = np.arange(py - r, py + r + 1)
    n = len(ys) - 1
    circ = -np.sqrt(np.maximum((n / 2) ** 2 - (ys - py) ** 2, 0.0)) * cfg.horizontal_scale
    # sill cells: movable layer with canonical profile baked into height
    _paint(cell.h, px - l1 // 2, py - r,
           np.broadcast_to(circ[None, :], (l1 + 1, len(ys))).copy())
    _rect(cell.layer, px - l1 // 2, py - r, l1 + 1, 2 * r + 1, LAYER_TIRE)
    # top ring: overhead half of the tire aperture (URDF collision mesh in
    # the reference) as a ceiling surface following the joint height
    _paint(cell.ceil, px - l1 // 2, py - r,
           np.broadcast_to(-circ[None, :], (l1 + 1, len(ys))).copy())
    _rect(cell.ceil_layer, px - l1 // 2, py - r, l1 + 1, 2 * r + 1, LAYER_TIRE)
    _rect(cell.h, px - l2 // 2, py - w // 2, l2, w // 2 - r, 1.5)
    _rect(cell.h, px - l2 // 2, py + r, l2, w // 2 - r, 1.5)
    # solid side frames have no overhead aperture — drop any ring-edge
    # ceiling cells their footprint overlaps
    wall = cell.h >= 1.5 - 1e-6
    cell.ceil[wall] = NO_CEILING
    cell.ceil_layer[wall] = 0
    box = (slice(px - l2 // 2, px + l2 // 2 + 1), slice(py - w // 2, py + w // 2 + 1))
    cell.edge[box] |= (cell.h[box] != 0) | (cell.layer[box] != 0)
    g = np.zeros((4, 3))
    g[0] = [pos[0] - 1.8, pos[1], 0.3]
    g[1] = [pos[0] - 0.9, pos[1], 0.3]
    g[2] = [pos[0], pos[1], 0.0]          # z += tire height via goal_layer
    g[3] = [pos[0] + 0.9, pos[1], 0.3]
    return g, np.array([0, 0, LAYER_TIRE, 0], np.int8)


def _tunnel(cell: _Cell, pos):
    cfg = cell.cfg
    px, py = cell.px(pos[0]), cell.px(pos[1])
    r = cell.px(0.4)
    L = cell.px(2.0)
    ys = np.arange(py - r, py + r + 1)
    n = len(ys) - 1
    half = np.sqrt(np.maximum((n / 2) ** 2 - (ys - py) ** 2, 0.0)) * cfg.horizontal_scale
    radius_m = (n / 2) * cfg.horizontal_scale
    circ = radius_m - half          # tube floor: r - sqrt(r^2 - dy^2)
    _paint(cell.h, px, py - r, np.broadcast_to(circ[None, :], (L + 1, len(ys))).copy())
    # tube roof: r + sqrt(r^2 - dy^2) — the overhang the robot must crouch
    # under (URDF tube mesh in the reference, obstacle.py:482-523)
    _paint(cell.ceil, px, py - r,
           np.broadcast_to((radius_m + half)[None, :], (L + 1, len(ys))).copy())
    g = np.zeros((4, 3))
    g[0] = [pos[0] - 1.0, pos[1], 0.3]
    g[1] = [pos[0] - 0.5, pos[1], 0.3]
    g[2] = [pos[0] + 1.0, pos[1], 0.3]
    g[3] = [pos[0] + 2.0 + 0.5, pos[1], 0.3]
    return g, np.zeros(4, np.int8)


_RASTER = {
    "bar_jump": _bar_jump, "frame": _a_frame, "poles": _poles,
    "seesaw": _seesaw, "tire_jump": _tire_jump, "tunnel": _tunnel,
}
# x offsets applied to some obstacle anchors (obstacle.py:118-136)
_POS_BIAS = {"poles": (-1.5, 0.0), "tunnel": (-1.0, 0.0)}


def generate(cfg: ObstacleCfg, seed: int = 0) -> CourseWorld:
    rng = np.random.default_rng(seed)
    n_x = int(cfg.env_length / cfg.horizontal_scale)
    n_y = int(cfg.env_width / cfg.horizontal_scale)
    cols = max(1, int(np.floor(np.sqrt(cfg.courses))))
    rows = int(np.ceil(cfg.courses / cols))
    border = int(cfg.border_size / cfg.horizontal_scale)
    H = rows * n_x + 2 * border
    W = cols * n_y + 2 * border
    height = np.zeros((H, W), np.float32)
    layer_id = np.zeros((H, W), np.int8)
    x_edge = np.zeros((H, W), bool)
    ceil_g = np.full((H, W), NO_CEILING, np.float32)
    ceil_layer_g = np.zeros((H, W), np.int8)
    lever_g = np.zeros((H, W), np.float32)
    n_goals_total = cfg.num_obst_per_env * cfg.num_goals + cfg.last_goal_repeat
    goals = np.zeros((cfg.courses, n_goals_total, 3))
    goal_layer = np.zeros((cfg.courses, n_goals_total), np.int8)
    obst_types = np.zeros((cfg.courses, 6), np.int32)
    obst_yaws = np.zeros((cfg.courses, 6))
    course_origins = np.zeros((cfg.courses, 3))
    robot_org = np.zeros((cfg.courses, 3))
    seesaw_pose = np.zeros((cfg.courses, 5))
    stations = np.asarray(cfg.frame_pos)             # (6, 2, 2)
    station_mid = stations.mean(axis=1)              # (6, 2)
    station_yaw = np.radians(np.asarray(cfg.frame_ang_deg))

    for ci in range(cfg.courses):
        row, col = divmod(ci, cols)
        ox = row * n_x + border
        oy = col * n_y + border
        cell = _Cell(cfg)

        order = rng.permutation(6)
        for j in range(6):
            t_idx = int(order[j])
            name = OBST_TYPES[t_idx]
            bias = np.asarray(_POS_BIAS.get(name, (0.0, 0.0)))
            noise = np.array([
                rng.uniform(*cfg.random_x), rng.uniform(*cfg.random_y)])
            pos = station_mid[j] + noise + bias
            yaw = station_yaw[j] + np.radians(rng.uniform(*cfg.random_yaw_deg))

            sub = _Cell(cfg)
            g, gl = _RASTER[name](sub, pos)
            _rot_into(cell, sub, (sub.px(pos[0]), sub.px(pos[1])), yaw)
            # rotate goals about the obstacle anchor
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -s], [s, c]])
            rel = g[:, :2] - pos
            g[:, :2] = (R @ rel.T).T + pos
            sl = slice(j * cfg.num_goals, (j + 1) * cfg.num_goals)
            goals[ci, sl] = g + np.array(
                [ox * cfg.horizontal_scale, oy * cfg.horizontal_scale, 0.0]) + np.array(
                [cfg.border_size * 0, 0, 0])
            goal_layer[ci, sl] = gl
            obst_types[ci, j] = t_idx
            obst_yaws[ci, j] = yaw
            if name == "seesaw":
                seesaw_pose[ci, :3] = [
                    pos[0] + ox * cfg.horizontal_scale - cfg.border_size,
                    pos[1] + oy * cfg.horizontal_scale - cfg.border_size,
                    yaw]

        # border walls (obstacle.py:222-233): 0.1 m thick, around the cell
        t = int(0.1 / cfg.horizontal_scale)
        bh = cfg.border_height
        cell.h[:t, :] = bh
        cell.h[-t:, :] = bh
        cell.h[:, :t] = bh
        cell.h[:, -t:] = bh

        # along-plank extent surviving later stamps (clips the analytic lever)
        lx, ly = np.nonzero(cell.lever)
        if len(lx):
            wx = lx * cfg.horizontal_scale + ox * cfg.horizontal_scale - cfg.border_size
            wy = ly * cfg.horizontal_scale + oy * cfg.horizontal_scale - cfg.border_size
            c0, s0 = np.cos(seesaw_pose[ci, 2]), np.sin(seesaw_pose[ci, 2])
            tt = c0 * (wx - seesaw_pose[ci, 0]) + s0 * (wy - seesaw_pose[ci, 1])
            seesaw_pose[ci, 3] = tt.min()
            seesaw_pose[ci, 4] = tt.max()

        box = (slice(ox, ox + n_x), slice(oy, oy + n_y))
        height[box] = cell.h
        layer_id[box] = cell.layer
        x_edge[box] = cell.edge
        ceil_g[box] = cell.ceil
        ceil_layer_g[box] = cell.ceil_layer
        lever_g[box] = cell.lever
        course_origins[ci] = [ox * cfg.horizontal_scale - cfg.border_size,
                              oy * cfg.horizontal_scale - cfg.border_size, 0.0]
        # repeat final goal
        goals[ci, 6 * cfg.num_goals :] = goals[ci, 6 * cfg.num_goals - 1]
        robot_org[ci] = [ox * cfg.horizontal_scale - cfg.border_size + cfg.robot_org[0],
                         oy * cfg.horizontal_scale - cfg.border_size + cfg.robot_org[1], 0.0]

    # goals are stored in cell-grid coordinates; shift into world frame
    goals[:, :, 0] -= cfg.border_size
    goals[:, :, 1] -= cfg.border_size

    return CourseWorld(
        height=height, layer_id=layer_id, x_edge=x_edge,
        ceil=ceil_g, ceil_layer=ceil_layer_g, lever=lever_g,
        hscale=cfg.horizontal_scale,
        origin=(-cfg.border_size, -cfg.border_size),
        course_origins=course_origins, goals=goals, goal_layer=goal_layer,
        obst_types=obst_types, obst_yaws=obst_yaws, robot_org=robot_org,
        seesaw_pose=seesaw_pose)


def sample_obstacle_heights(cfg: ObstacleCfg, rng, n, lo_bar=None, hi_bar=None,
                            lo_tire=None, hi_tire=None):
    """Per-env movable heights (curriculum-adjustable ranges)."""
    br = (lo_bar if lo_bar is not None else cfg.bar_jump_range[0],
          hi_bar if hi_bar is not None else cfg.bar_jump_range[1])
    tr = (lo_tire if lo_tire is not None else cfg.tire_jump_range[0],
          hi_tire if hi_tire is not None else cfg.tire_jump_range[1])
    return rng.uniform(*br, n), rng.uniform(*tr, n)
