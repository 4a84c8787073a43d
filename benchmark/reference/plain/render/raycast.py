"""On-device depth camera: a heightfield ray-caster (counterpart of
agility_tpu/render/raycast.py).

A frozen plain-torch copy of agility_tpu_torch/render/raycast.py for the
benchmark's reference (it imports nothing of the program).  Departure from
the source (legged_robot_config.py:63-84, the simulator's depth camera
read back and resized): the image is ray-marched against the heightfield
the physics collides with, 32 samples a ray and one secant step, with one
ray per pixel of the resized 87 x 58 image at the stated horizontal FOV.

Rays from the base-mounted front camera (position [0.305, 0.0175, 0.098] in
the base frame, horizontal FOV 87 deg) are marched against the same
HeightGrid the physics collides with; the first surface crossing gives
metric depth, which `process_depth` clips to [near, far], normalises to
[-0.5, 0.5] and perturbs with a global and a per-pixel uniform noise.

Everything is fixed-shape and batched over envs: `n_steps` march samples
per ray, the first crossing found by argmax, then one secant step between
the straddling samples.  A pixel's first crossing is discontinuous in the
sampled heights: a float32 difference in a clearance that lies within
rounding of zero moves the crossing by one sample.  The march is plain
torch on either device; it holds no kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.plain.core import quat as qm
from benchmark.reference.plain.physics import heightfield as hf

# [m] a clearance this close to zero may change sign under a float32
# difference in the sampled surfaces (two implementations' grid
# coordinates differ by an ulp, up to 6e-5 m of clearance on tall faces)
CROSSING_EPS = 1e-4


class CameraModel(NamedTuple):
    dirs: torch.Tensor        # (H*W, 3) ray directions, camera frame (+x fwd)
    offset: torch.Tensor      # (3,) mount position in the base frame
    ts: torch.Tensor          # (n_steps,) march distances from near to far
    width: int
    height: int
    near: float
    far: float
    n_steps: int


class DepthNoise(NamedTuple):
    """One refresh's unit uniforms for N envs, in the JAX key split's order."""
    level: torch.Tensor       # (N,) the per-pixel noise's amplitude
    offset: torch.Tensor      # (N,) the global offset
    pixel: torch.Tensor       # (N, H, W)


def make_camera(width=87, height=58, horizontal_fov_deg=87.0,
                position=(0.305, 0.0175, 0.098), near=0.3, far=4.0,
                n_steps=32, device="cuda") -> CameraModel:
    hfov = np.radians(horizontal_fov_deg)
    fx = (width / 2) / np.tan(hfov / 2)
    u = np.arange(width) - (width - 1) / 2
    v = np.arange(height) - (height - 1) / 2
    uu, vv = np.meshgrid(u, v, indexing="xy")      # (H, W)
    # camera frame: +x forward, +y left, +z up (image u -> -y, v -> -z)
    dirs = np.stack([np.ones_like(uu) * fx, -uu, -vv], axis=-1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return CameraModel(
        dirs=f32(dirs.reshape(-1, 3)), offset=f32(position),
        ts=f32(np.linspace(near, far, n_steps)), width=width, height=height,
        near=float(near), far=float(far), n_steps=n_steps)


def march_points(cam: CameraModel, base_pos, base_quat, cam_pitch):
    """(N, H*W, n_steps, 3) world positions of every march sample.
    base_pos (N, 3), base_quat (N, 4), cam_pitch (N,) extra mount pitch
    [rad], positive down."""
    # mount rotation: pitch about the camera's y axis, then the base orientation
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=base_pos.device)
    pitch_q = qm.quat_from_axis_angle(y_axis, cam_pitch)                    # (N, 4)
    dirs_w = qm.quat_rotate(base_quat[:, None], qm.quat_rotate(pitch_q[:, None], cam.dirs))
    origin = base_pos + qm.quat_rotate(base_quat, cam.offset)                # (N, 3)
    return origin[:, None, None, :] + dirs_w[:, :, None, :] * cam.ts[:, None]


def clearance(cam: CameraModel, grid: hf.HeightGrid, base_pos, base_quat, cam_pitch,
              hf_weights=None):
    """(N, H*W, n_steps) signed clearance of every march sample: height over
    the floor, or under a ceiling surface (tunnel roof, tire top ring) where
    that is smaller; negative inside solid.  hf_weights (N, L) are the
    per-env surface weights."""
    x, y, z = march_points(cam, base_pos, base_quat, cam_pitch).unbind(-1)
    f = z - hf.sample_height(grid, x, y, hf_weights)
    if grid.ceiling is not None:
        f = torch.minimum(f, hf.sample_ceiling(grid, x, y, hf_weights) - z)
    return f


def render_depth(cam: CameraModel, grid: hf.HeightGrid, base_pos, base_quat, cam_pitch,
                 hf_weights=None):
    """Metric depth (N, H, W): the first crossing of each ray, refined by one
    secant step between the straddling samples; `far` where nothing is hit."""
    f = clearance(cam, grid, base_pos, base_quat, cam_pitch, hf_weights)
    below = f < 0
    idx = torch.argmax(below.to(torch.uint8), dim=-1)     # first crossing (0 if none)
    any_hit = below.any(dim=-1)
    i1 = torch.clamp(idx, 1, cam.n_steps - 1)
    i0 = i1 - 1
    f0 = torch.gather(f, -1, i0[..., None])[..., 0]
    f1 = torch.gather(f, -1, i1[..., None])[..., 0]
    t0, t1 = cam.ts[i0], cam.ts[i1]
    df = f1 - f0
    tau = t0 - f0 * (t1 - t0) / torch.where(torch.abs(df) < 1e-9, 1e-9, df)
    depth = torch.where(any_hit, torch.clamp(tau, cam.near, cam.far), cam.far)
    return depth.reshape(-1, cam.height, cam.width)


def crossing_mask(cam: CameraModel, grid: hf.HeightGrid, base_pos, base_quat, cam_pitch,
                  hf_weights=None):
    """(N, H, W) True at the pixels whose depth no float32 difference in the
    sampled surfaces can move by a march sample, for comparing two
    implementations' depth: every clearance up to the first crossing (the
    last sample where nothing is hit) at least CROSSING_EPS from zero, and no
    straddling sample of a hit taking its clearance from the ceiling in a
    ceiling-edge cell (some node open sky, some not: the bilinear blend of
    the NO_CEILING sentinel with the roof is a ramp of ~2000 m per m, where
    one ulp of the grid coordinate moves the clearance by up to 3e-3 m)."""
    f = clearance(cam, grid, base_pos, base_quat, cam_pitch, hf_weights)
    below = f < 0
    S = f.shape[-1]
    last = torch.where(below.any(-1), torch.argmax(below.to(torch.uint8), -1), S - 1)
    upto = torch.arange(S, device=f.device) <= last[..., None]
    keep = ~((torch.abs(f) < CROSSING_EPS) & upto).any(-1)
    if grid.ceiling is not None:
        i1 = torch.clamp(last, 1, S - 1)
        pts = march_points(cam, base_pos, base_quat, cam_pitch)
        for i in (i1 - 1, i1):
            x, y, z = torch.gather(pts, 2, i[..., None, None].expand(-1, -1, 1, 3))[:, :, 0].unbind(-1)
            gx, gy = hf._grid_coords(grid, x, y)
            x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
            sky = torch.stack([grid.ceiling[x0 + a, y0 + b] for a in (0, 1) for b in (0, 1)]
                              ) >= hf.NO_CEILING
            roof = (hf.sample_ceiling(grid, x, y, hf_weights) - z
                    < z - hf.sample_height(grid, x, y, hf_weights))
            keep &= ~(below.any(-1) & roof & sky.any(0) & ~sky.all(0))
    return keep.reshape(-1, cam.height, cam.width)


def draw_depth_noise(gen: torch.Generator, n: int, height: int, width: int) -> DepthNoise:
    """One refresh's draws from `gen` (on its device): level, offset, pixel."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=gen.device)
    return DepthNoise(u(n), u(n), u(n, height, width))


def process_depth(depth, near: float, far: float, noise: DepthNoise, depth_noise: float = 0.05):
    """The reference's process_depth_image on (N, H, W) depth: clip,
    normalise to [-0.5, 0.5], add a global and a per-pixel uniform noise."""
    d = torch.clamp(depth, near, far)
    d = (d - near) / (far - near) - 0.5
    level = (depth_noise * noise.level)[:, None, None]
    d = d + depth_noise * 2.0 * (noise.offset[:, None, None] - 0.5)
    return d + level * 2.0 * (noise.pixel - 0.5)
