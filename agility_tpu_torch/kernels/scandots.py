"""K3: the scandot measurement, as a hand-written CUDA kernel and its plain-torch twin.

Replaces agility_tpu/physics/windows.py:measure_scandots_band (Pallas kernel
at windows.py:448, pallas_call at :205).  The CUDA source, csrc/scandots.cu,
says what bounds it on the card and how its design answers that.  The plain
version is physics/patch.py:measure_scandots_batch (bf16 floor fold, then
min(node, +x, +y) at each point's floor node).

`scandots` dispatches on the tensors' device alone: CPU tensors take the
plain version; CUDA tensors launch the kernel, or raise.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build
from agility_tpu_torch.kernels.terrain_window import check_f32, check_grid, ptr
from agility_tpu_torch.physics import patch as pt
from agility_tpu_torch.physics.heightfield import HeightGrid

TPU_KERNEL = "agility_tpu/physics/windows.py:415"   # measure_scandots_band; kernel :448, pallas_call :205
SOURCE = "agility_tpu_torch/csrc/scandots.cu"
MAX_WEIGHTS = 8     # weight columns the kernel holds per thread

scandots_reference = pt.measure_scandots_batch

_FLOOR = (("height", torch.float32), ("lever", torch.float32), ("layer_id", torch.int8))


def _lib():
    fn = build.load("scandots").scandots_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3 + \
            [ctypes.c_int] + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


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
        launch = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(ptr(grid.height), ptr(grid.lever), ptr(grid.layer_id),
                         ptr(centers_xy), ptr(weights), ptr(px), ptr(py), N, K, L, H, W,
                         grid.origin[0], grid.origin[1], grid.hscale, P, ptr(out), stream)
        if err != 0:
            raise RuntimeError(f"scandots kernel launch failed: cudaError {err}")
        scandots.launches += 1
    return out


scandots.launches = 0
