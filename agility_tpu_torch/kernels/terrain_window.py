"""K2: the per-env terrain window, as a hand-written CUDA kernel and its plain-torch twin.

Replaces agility_tpu/physics/windows.py:extract_band_batch (Pallas kernel at
windows.py:341, pallas_call at :205).  The CUDA source,
csrc/terrain_window.cu, says what bounds it on the card and how its design
answers that.  The plain version is physics/patch.py:extract_batch.

`terrain_window` dispatches on the tensors' device alone: CPU tensors take
the plain version; CUDA tensors launch the kernel, or raise.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build
from agility_tpu_torch.physics import patch as pt
from agility_tpu_torch.physics.heightfield import HeightGrid

TPU_KERNEL = "agility_tpu/physics/windows.py:312"   # extract_band_batch; kernel :341, pallas_call :205
SOURCE = "agility_tpu_torch/csrc/terrain_window.cu"

terrain_window_reference = pt.extract_batch

_SURFACES = (("height", torch.float32), ("lever", torch.float32),
             ("layer_id", torch.int8), ("ceiling", torch.float32),
             ("ceiling_layer", torch.int8))


def _lib():
    fn = build.load("terrain_window").terrain_window_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + \
            [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def check_grid(name: str, grid: HeightGrid, dev: torch.device, surfaces=_SURFACES):
    """Raise unless every present surface is a contiguous (H, W) tensor of
    its dtype on `dev`."""
    shape = tuple(grid.height.shape)
    for field, dt in surfaces:
        t = getattr(grid, field)
        if t is not None and (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: grid.{field} must be a contiguous {dt} {shape} "
                             f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_f32(name: str, arg: str, t: torch.Tensor, shape, dev: torch.device):
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be a contiguous float32 {tuple(shape)} tensor "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def ptr(t):
    return None if t is None else t.data_ptr()


def terrain_window(grid: HeightGrid, centers_xy: torch.Tensor, size: int,
                   weights: torch.Tensor = None) -> pt.Patch:
    """K2 on the tensors' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Same arguments and result as
    patch.extract_batch.  Each kernel launch adds one to
    `terrain_window.launches`."""
    dev = centers_xy.device
    if dev.type == "cpu":
        return terrain_window_reference(grid, centers_xy, size, weights)
    if dev.type != "cuda":
        raise ValueError(f"terrain_window: no kernel for device {dev}")
    H, W = grid.height.shape
    N = centers_xy.shape[0]
    P = min(size, H, W)
    check_grid("terrain_window", grid, dev)
    check_f32("terrain_window", "centers_xy", centers_xy, (N, 2), dev)
    L = 0
    if weights is not None:
        L = weights.shape[-1]
        check_f32("terrain_window", "weights", weights, (N, L), dev)
    values = torch.empty((N, P, P), dtype=torch.float32, device=dev)
    ceil = torch.empty_like(values) if grid.ceiling is not None else None
    x0 = torch.empty(N, dtype=torch.int64, device=dev)
    y0 = torch.empty_like(x0)
    if N:
        launch = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(ptr(grid.height), ptr(grid.lever), ptr(grid.layer_id),
                         ptr(grid.ceiling), ptr(grid.ceiling_layer), ptr(centers_xy),
                         ptr(weights), N, L, H, W, grid.origin[0], grid.origin[1],
                         grid.hscale, P, ptr(values), ptr(ceil), ptr(x0), ptr(y0), stream)
        if err != 0:
            raise RuntimeError(f"terrain_window kernel launch failed: cudaError {err}")
        terrain_window.launches += 1
    return pt.Patch(values=values, x0=x0, y0=y0, hscale=grid.hscale, origin=grid.origin,
                    ceil=ceil)


terrain_window.launches = 0
