"""K2: the per-env terrain window, as a hand-written CUDA kernel and its plain-torch twin.

Replaces agility_tpu/physics/windows.py:extract_band_batch (Pallas kernel at
windows.py:341, pallas_call at :205).  The CUDA source,
csrc/terrain_window.cu, says what bounds it on the card and how its design
answers that.  The plain version is physics/patch.py:extract_batch.

`terrain_window` dispatches on the tensors' device alone: CPU tensors take
the plain version; CUDA tensors launch the kernel, or raise.

Where the grid's width allows (W % 4 == 0, every grid the paths use), the
kernel runs persistent blocks that stage each env's window of every surface
in a shared-memory ring, the float32 surfaces with TMA tiled loads and the
int8 tags with 4-byte cp.async words; otherwise one block per env with
plain loads.  `launch_config` computes its launch parameters and each
surface's route from the shapes alone, so the CPU tests check the rules
that the kernel's launcher checks again.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build
from agility_tpu_torch.physics import patch as pt
from agility_tpu_torch.physics.heightfield import HeightGrid

TPU_KERNEL = "agility_tpu/physics/windows.py:312"   # extract_band_batch; kernel :341, pallas_call :205
SOURCE = "agility_tpu_torch/csrc/terrain_window.cu"
MAX_SIZE = 45               # a window's cells / CELLS fit the most threads a block runs
MAX_WEIGHTS = 8             # weight columns a thread holds
MAX_SMEM = 232_448          # bytes of shared memory a block can use on Hopper (227 KB)
MAX_THREADS = 512           # the kernels' __launch_bounds__ (csrc/window_ring.cuh)
STAGES = 3                  # ring stages in shared memory
RING_BYTES = 64 * 40 + STAGES * 8   # the env ring (64 origins + 8 weights) and the barriers
ALIGN_PAD = 128             # the stages start 128-byte aligned in the block's memory
CELLS = 4                   # consecutive window cells a thread folds

terrain_window_reference = pt.extract_batch

_SURFACES = (("height", torch.float32), ("lever", torch.float32),
             ("layer_id", torch.int8), ("ceiling", torch.float32),
             ("ceiling_layer", torch.int8))
_DTYPE = dict(_SURFACES)


def window_box(P: int):
    """(bw, box_bytes, tag_bytes): a staged window's box starts at column
    y0 & ~3 (a TMA box whose first column is not 16-byte aligned faults on
    the card), so it is P rows of bw = P + 3 columns rounded up to 4 (a TMA
    box's rows must be whole 16-byte multiples); a float32 box takes
    box_bytes of a stage and an int8 box tag_bytes, each rounded up to 128
    bytes (a TMA destination must be 128-byte aligned)."""
    bw = -(-(P + 3) // 4) * 4
    return bw, -(-P * bw * 4 // 128) * 128, -(-P * bw // 128) * 128


def routes(W: int, surfaces) -> dict:
    """Each surface's copy route, from the grid's width alone: where
    W % 4 == 0, a float32 surface by "tma" (its row pitch, 4 W bytes, a
    multiple of 16 as a TMA tensor map needs) and an int8 one by "cp.async"
    (4-byte words; TMA would need W % 16 == 0, which the course grid's 1800
    is not); otherwise every surface by "plain" loads."""
    if W % 4:
        return {s: "plain" for s in surfaces}
    return {s: "tma" if _DTYPE[s] == torch.float32 else "cp.async" for s in surfaces}


def launch_config(N: int, P: int, W: int, surfaces, sm_count: int, blocks_per_sm: int) -> dict:
    """K2's launch parameters for N windows of P x P cells on a grid W wide
    that read `surfaces` (names of HeightGrid fields): one thread per CELLS
    consecutive cells of the row-major window, rounded up to whole warps.
    Where W % 4 == 0 the staged design: the routes, the box width bw, the
    shared memory (ALIGN_PAD, STAGES stages of the surfaces' boxes, the env
    ring and the barriers) and the grid of persistent blocks,
    min(N, blocks_per_sm * sm_count).  Otherwise one block per env (no
    shared memory: smem, bw, staged 0) and plain loads."""
    if not 1 <= P <= MAX_SIZE:
        raise ValueError(f"terrain_window: the kernel takes windows of 1..{MAX_SIZE} cells, "
                         f"got {P}")
    chunks = -(-P * P // CELLS)
    threads = 32 * -(-chunks // 32)
    r = routes(W, surfaces)
    if W % 4:
        return dict(threads=threads, grid=max(1, N), smem=0, bw=0, staged=0, routes=r)
    bw, box_bytes, tag_bytes = window_box(P)
    stage = sum(box_bytes if v == "tma" else tag_bytes for v in r.values())
    smem = ALIGN_PAD + STAGES * stage + RING_BYTES
    if smem > MAX_SMEM:
        raise ValueError(f"terrain_window: P = {P} needs {smem} bytes of shared memory; a block "
                         f"takes at most {MAX_SMEM}")
    return dict(threads=threads, bw=bw, smem=smem, grid=max(1, min(N, blocks_per_sm * sm_count)),
                staged=1, routes=r)


_OCCUPANCY = {}     # (device index, threads, smem) -> blocks of the staged design per SM
_CONFIGS = {}       # (device index, shapes) -> device_launch_config


def _lib():
    lib = build.load("terrain_window")
    if lib.terrain_window_launch.argtypes is None:
        lib.terrain_window_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.terrain_window_launch.restype = ctypes.c_int
        lib.terrain_window_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.terrain_window_blocks_per_sm.restype = ctypes.c_int
    return lib


def used_surfaces(grid: HeightGrid, weights) -> tuple:
    """(the surfaces the fold reads, nl): the lever only with weights (the
    tilt), the tags only where there are layer weights to add, nl of them
    (the weights less the tilt column)."""
    nl = 0
    if weights is not None:
        nl = weights.shape[-1] - (1 if grid.lever is not None else 0)
    used = ["height"]
    if grid.lever is not None and weights is not None:
        used.append("lever")
    if grid.layer_id is not None and nl > 0:
        used.append("layer_id")
    if grid.ceiling is not None:
        used.append("ceiling")
        if grid.ceiling_layer is not None and nl > 0:
            used.append("ceiling_layer")
    return tuple(used), nl


def device_launch_config(N: int, P: int, grid: HeightGrid, weights, dev: torch.device) -> dict:
    """`launch_config` on card `dev` for this grid's used surfaces."""
    return _config(N, P, grid.height.shape[1], used_surfaces(grid, weights)[0], dev)


def _config(N: int, P: int, W: int, surfaces: tuple, dev: torch.device) -> dict:
    """`launch_config` on card `dev`: its SM count and, for the staged
    design, the blocks that fit on one SM by the occupancy query (cached per
    device and shapes)."""
    key = (dev.index, N, P, W, surfaces)
    if key not in _CONFIGS:
        one = launch_config(1, P, W, surfaces, 1, 1)
        if one["staged"]:
            k = (dev.index, one["threads"], one["smem"])
            if k not in _OCCUPANCY:
                blocks = _lib().terrain_window_blocks_per_sm(one["threads"], one["smem"])
                if blocks <= 0:
                    raise RuntimeError(f"terrain_window: occupancy query gave {blocks} blocks "
                                       f"per SM for {one}")
                _OCCUPANCY[k] = blocks
            sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
            _CONFIGS[key] = dict(launch_config(N, P, W, surfaces, sm_count, _OCCUPANCY[k]),
                                 blocks_per_sm=_OCCUPANCY[k])
        else:
            _CONFIGS[key] = launch_config(N, P, W, surfaces, 1, 1)
    return _CONFIGS[key]


def check_staged_aligned(name: str, grid: HeightGrid, cfg: dict):
    """Raise unless every staged surface starts aligned for its copies:
    16 bytes for TMA, 4 for cp.async words (the launcher refuses them
    otherwise; this says why)."""
    for s, r in cfg["routes"].items():
        need = {"tma": 16, "cp.async": 4}.get(r, 1)
        if getattr(grid, s).data_ptr() % need:
            raise ValueError(f"{name}: grid.{s} must start {need}-byte aligned for its {r} "
                             f"copies")


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
        if L > MAX_WEIGHTS:
            raise ValueError(f"terrain_window: the kernel takes at most {MAX_WEIGHTS} weights, "
                             f"got {L}")
    values = torch.empty((N, P, P), dtype=torch.float32, device=dev)
    ceil = torch.empty_like(values) if grid.ceiling is not None else None
    x0 = torch.empty(N, dtype=torch.int64, device=dev)
    y0 = torch.empty_like(x0)
    if N:
        surfaces, nl = used_surfaces(grid, weights)
        use = lambda f: getattr(grid, f) if f in surfaces else None
        lib = _lib()
        with torch.cuda.device(dev):
            cfg = _config(N, P, W, surfaces, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.terrain_window_launch(
                ptr(grid.height), ptr(use("lever")), ptr(use("layer_id")), ptr(grid.ceiling),
                ptr(use("ceiling_layer")), ptr(centers_xy), ptr(weights), N, L, nl, H, W,
                grid.origin[0], grid.origin[1], grid.hscale, P, ptr(values), ptr(ceil),
                ptr(x0), ptr(y0), cfg["threads"], cfg["bw"], cfg["smem"], cfg["grid"],
                cfg["staged"], stream)
        if err != 0:
            check_staged_aligned("terrain_window", grid, cfg)
            raise RuntimeError(f"terrain_window kernel launch failed: cudaError {err}")
        terrain_window.launches += 1
    return pt.Patch(values=values, x0=x0, y0=y0, hscale=grid.hscale, origin=grid.origin,
                    ceil=ceil)


terrain_window.launches = 0
