"""K3: the scandot measurement, as a hand-written CUDA kernel and its plain-torch twin.

Replaces agility_tpu/physics/windows.py:measure_scandots_band (Pallas kernel
at windows.py:448, pallas_call at :205).  The CUDA source, csrc/scandots.cu,
says what bounds it on the card and how its design answers that.  The plain
version is physics/patch.py:measure_scandots_batch (bf16 floor fold, then
min(node, +x, +y) at each point's floor node).

`scandots` dispatches on the tensors' device alone: CPU tensors take the
plain version; CUDA tensors launch the kernel, or raise.

The kernel gathers each scan's nodes from the grid, one warp per env
(csrc/scandots.cu says why that beat staging each env's window in shared
memory as K2 does).  `launch_config` computes its launch parameters from
N and K alone.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build
from agility_tpu_torch.kernels.terrain_window import MAX_WEIGHTS, check_f32, check_grid, ptr
from agility_tpu_torch.physics import patch as pt
from agility_tpu_torch.physics.heightfield import HeightGrid

TPU_KERNEL = "agility_tpu/physics/windows.py:415"   # measure_scandots_band; kernel :448, pallas_call :205
SOURCE = "agility_tpu_torch/csrc/scandots.cu"
ENVS_PER_BLOCK = 8          # one warp an env
GROUP = 5                   # points a lane gathers; a warp takes 32 GROUP of them
ROUTE = "gather"            # every surface: node by node from the grid, whatever its width

scandots_reference = pt.measure_scandots_batch

_FLOOR = (("height", torch.float32), ("lever", torch.float32), ("layer_id", torch.int8))


def launch_config(N: int, K: int, P: int) -> dict:
    """K3's launch parameters for N scans of K points in windows of P cells,
    whatever the grid: a warp an env, ENVS_PER_BLOCK envs a block, `grid`
    blocks by `point_groups` along y (32 GROUP points a warp each), no
    shared memory.  A scan's nodes and their +x and +y neighbours need
    P >= 2."""
    if K < 1 or P < 2:
        raise ValueError(f"scandots: the kernel takes at least 1 point and windows of at least "
                         f"2 cells, got K = {K}, P = {P}")
    return dict(threads=32 * ENVS_PER_BLOCK, grid=max(1, -(-N // ENVS_PER_BLOCK)),
                point_groups=-(-K // (32 * GROUP)))


def _lib():
    lib = build.load("scandots")
    if lib.scandots_launch.argtypes is None:
        lib.scandots_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 2 + \
            [ctypes.c_void_p]
        lib.scandots_launch.restype = ctypes.c_int
    return lib


def floor_inputs(grid: HeightGrid, weights) -> tuple:
    """(lever, layer_id, nl): the surfaces the fold reads besides the
    height, as K2 reads them (the lever only with weights, the tilt; the
    tags only where there are nl > 0 layer weights to add), else None."""
    if weights is None:
        return None, None, 0
    nl = weights.shape[-1] - (1 if grid.lever is not None else 0)
    return grid.lever, grid.layer_id if nl > 0 else None, nl


def used_surfaces(grid: HeightGrid, weights) -> tuple:
    """(names of the surfaces the fold reads, nl)."""
    lever, layer_id, nl = floor_inputs(grid, weights)
    names = ("height",) + (("lever",) if lever is not None else ()) + \
        (("layer_id",) if layer_id is not None else ())
    return names, nl


def scandots(grid: HeightGrid, centers_xy: torch.Tensor, size: int, weights: torch.Tensor,
             px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and result as
    patch.measure_scandots_batch: (N, K) float32.  Each kernel launch adds
    one to `scandots.launches`."""
    dev = centers_xy.device
    if dev.type == "cpu":
        return scandots_reference(grid, centers_xy, size, weights, px, py)
    if dev.type != "cuda":
        raise ValueError(f"scandots: no kernel for device {dev}")
    H, W = grid.height.shape
    N, K = px.shape
    P = min(size, H, W)
    check_grid("scandots", grid, dev, _FLOOR)
    for name, t, shape in (("centers_xy", centers_xy, (N, 2)), ("px", px, (N, K)),
                           ("py", py, (N, K))):
        check_f32("scandots", name, t, shape, dev)
    L = 0
    if weights is not None:
        L = weights.shape[-1]
        check_f32("scandots", "weights", weights, (N, L), dev)
        if L > MAX_WEIGHTS:
            raise ValueError(f"scandots: the kernel takes at most {MAX_WEIGHTS} weights, got {L}")
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    if N * K:
        lever, layer_id, nl = floor_inputs(grid, weights)
        cfg = launch_config(N, K, P)
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.scandots_launch(
                ptr(grid.height), ptr(lever), ptr(layer_id), ptr(centers_xy), ptr(weights),
                ptr(px), ptr(py), N, K, L, nl, H, W, grid.origin[0], grid.origin[1],
                grid.hscale, P, ptr(out), cfg["grid"], cfg["point_groups"], stream)
        if err != 0:
            raise RuntimeError(f"scandots kernel launch failed: cudaError {err}")
        scandots.launches += 1
    return out


scandots.launches = 0
