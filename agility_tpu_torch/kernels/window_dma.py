"""D and E: the per-env window copies of the window-extraction A/B, as
hand-written CUDA kernels and their plain-torch twins.

D, `per_env_windows`, replaces tools/bench_windows.py:pallas_windows (Pallas
kernel at :224, pallas_call :262): each env's (K, P, Pc) window of the K
stacked surfaces G (K, H, W) at its exact origin (x0, y0), no fold, no
clamp.  E, `band_windows`, replaces tools/bench_windows.py:pallas_band_dma
(kernel :169, pallas_call :200): each env's (P8, KB) slab of the band
stack G2 (nb, Hp, KB) that `band_stack` builds, at the 8- or 16-row
aligned origin x0a and the band yb, with JAX's clips:

    x0a = clip((x0 // al) * al, 0, Hp - P8),  yb = clip(y0 // stride, 0, nb - 1)

Both are copies, generic over float32 and bfloat16, so the kernels are
bit-exact with the plain versions.  The CUDA source, csrc/window_dma.cu,
says what bounds them on the card and how they are built.

D has two routes, chosen from the shapes and G's base pointer alone
(`per_env_config`, a pure function the CPU tests check): "tma", persistent
blocks streaming one 3-d TMA box an env through a ring of shared-memory
stages, where G's row pitch is a multiple of 16 bytes, G starts 16-byte
aligned, the box fits TMA's limits and two stages fit in shared memory;
"rows", one block an env copying row by row, everywhere else.

Out of range: the TPU's DMA reads D's window wherever (x0, y0) puts it.
Here nothing reads outside G: a window cell whose row is outside [0, H) or
whose column is outside [0, W) is zero, in the kernel and the plain
version alike.  E's clips keep every slab inside G2 (the wrappers require
Hp >= P8).

Each wrapper dispatches on the tensors' device alone: CPU tensors take the
plain version; CUDA tensors launch the kernel, or raise.  Each launch adds
one to `per_env_windows.launches` / `band_windows.launches`, and D's to
`per_env_windows.route_launches[route]` too, which counts from import on
(read it as a difference: `zero_launch_counts` sets only `launches`).
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build

TPU_KERNEL_D = "tools/bench_windows.py:214"   # pallas_windows; kernel :224, pallas_call :262
TPU_KERNEL_E = "tools/bench_windows.py:144"   # pallas_band_dma; kernel :169, pallas_call :200
SOURCE = "agility_tpu_torch/csrc/window_dma.cu"
DTYPES = (torch.float32, torch.bfloat16)
_ESZ = {torch.float32: 4, torch.bfloat16: 2}   # bytes an element
THREADS = 256               # threads a block, either route of D
STAGES = 2                  # D's ring stages (csrc/window_dma.cu:kStagesD)
MAX_BOX = 256               # a TMA box's limit in each dim
MAX_SMEM = 232_448          # bytes of shared memory a block can use on Hopper (227 KB)
ALIGN_PAD = 128             # the stages start 128-byte aligned in the block's memory
BARRIER_BYTES = 16 * STAGES  # after the stages: each stage's mbarrier and env origin
ROUTES = ("rows", "tma")    # the launcher's route numbers


def sublane(dtype: torch.dtype) -> int:
    """E's row alignment `al` for a dtype: 8 rows of float32, 16 of bfloat16
    (the TPU's sublane tile, bench_windows.py:153)."""
    return 8 if dtype == torch.float32 else 16


def band_geometry(H: int, W: int, K: int, P: int, band: int, stride: int, al: int) -> dict:
    """The band stack's sizes (bench_windows.py:154-165): nb bands of
    `band` columns every `stride`, the padded width Wp, the rows Hp (H
    rounded up to al), the lanes KB (K * band rounded up to 128) and a
    slab's rows P8 (P + al rounded up to al)."""
    if band % stride:
        raise ValueError(f"band_stack: band {band} is not a multiple of stride {stride}")
    nb = max((W - P) // stride + 1, 1)
    Wp = (nb - 1) * stride + band
    if Wp < W:
        raise ValueError(f"band_stack: {nb} bands of {band} every {stride} end at column "
                         f"{Wp}, short of the grid's {W}")
    return dict(nb=nb, Wp=Wp, Hp=-(-H // al) * al, KB=-(-(K * band) // 128) * 128,
                P8=-(-(P + al) // al) * al)


def band_stack(G: torch.Tensor, P: int, band: int, stride: int, al: int) -> torch.Tensor:
    """G2 (nb, Hp, KB) from the surfaces G (K, H, W), as bench_windows.py:
    153-166 builds it: G padded to Wp columns, band b the columns [b *
    stride, b * stride + band) of every surface side by side, padded with
    zeros to Hp rows and KB lanes.  Plain torch, outside the kernel."""
    K, H, W = G.shape
    g = band_geometry(H, W, K, P, band, stride, al)
    nb = g["nb"]
    Gp = torch.nn.functional.pad(G, (0, g["Wp"] - W))
    R = Gp.reshape(K, H, g["Wp"] // stride, stride)
    G2 = torch.cat([R[:, :, i:i + nb] for i in range(band // stride)], dim=3)  # (K, H, nb, band)
    G2 = G2.permute(2, 1, 0, 3).reshape(nb, H, K * band)
    return torch.nn.functional.pad(G2, (0, g["KB"] - K * band, 0, g["Hp"] - H)).contiguous()


def per_env_windows_reference(G, x0, y0, P: int, Pc: int = None) -> torch.Tensor:
    """D's plain version: (N, K, P, Pc), zero where the window leaves G."""
    Pc = Pc or P
    K, H, W = G.shape
    rows = x0.long()[:, None] + torch.arange(P, device=G.device)        # (N, P)
    cols = y0.long()[:, None] + torch.arange(Pc, device=G.device)       # (N, Pc)
    inside = (((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :])
    win = G[:, rows.clamp(0, H - 1)[:, :, None], cols.clamp(0, W - 1)[:, None, :]]
    return torch.where(inside, win, torch.zeros((), dtype=G.dtype, device=G.device)) \
        .permute(1, 0, 2, 3).contiguous()


def band_origins(x0, y0, nb: int, Hp: int, P8: int, stride: int, al: int):
    """E's (x0a, yb) per env: JAX's clips of the floor divisions."""
    return (torch.clamp(torch.div(x0, al, rounding_mode="floor") * al, 0, Hp - P8),
            torch.clamp(torch.div(y0, stride, rounding_mode="floor"), 0, nb - 1))


def band_windows_reference(G2, x0, y0, P: int, band: int, stride: int, al: int) -> torch.Tensor:
    """E's plain version: (N, P8, KB), G2[yb, x0a : x0a + P8, :] per env."""
    nb, Hp, _ = G2.shape
    P8 = -(-(P + al) // al) * al
    x0a, yb = band_origins(x0.long(), y0.long(), nb, Hp, P8, stride, al)
    return G2[yb[:, None], x0a[:, None] + torch.arange(P8, device=G2.device)]


def rows_config(N: int) -> dict:
    """D's "rows" route: one block of THREADS an env, no shared memory."""
    return dict(route="rows", threads=THREADS, grid=max(1, N), bw=0, stage_bytes=0, stages=0,
                smem=0)


def per_env_config(N: int, K: int, H: int, W: int, P: int, Pc: int, dtype: torch.dtype,
                   sm_count: int, blocks_per_sm: int, base_ptr: int = 0) -> dict:
    """D's route and launch parameters for N windows of (K, P, Pc) on
    surfaces (K, H, W) of `dtype` starting at address `base_ptr`.

    A box starts at column y0 & ~(v - 1), v = 16 / element size (a TMA box
    whose first column is not 16-byte aligned faults on the card), so it is
    bw = Pc + v - 1 rounded up to v columns wide, P rows, K surfaces:
    stage_bytes = bw * P * K * element size, each stage rounded up to 128
    bytes in shared memory (a TMA destination's alignment).  The route is
    "tma" where the tensor map allows it (W * element size % 16 == 0,
    base_ptr % 16 == 0, bw, P and K <= MAX_BOX) and the ring fits a block's
    shared memory: smem = ALIGN_PAD + STAGES * the rounded stage +
    BARRIER_BYTES <= MAX_SMEM; then a grid of persistent blocks,
    min(N, blocks_per_sm * sm_count).  Otherwise `rows_config(N)`."""
    if dtype not in DTYPES:
        raise ValueError(f"per_env_windows: no kernel for {dtype}")
    esz = _ESZ[dtype]
    v = 16 // esz
    bw = -(-(Pc + v - 1) // v) * v
    stage_bytes = bw * P * K * esz
    smem = ALIGN_PAD + STAGES * -(-stage_bytes // 128) * 128 + BARRIER_BYTES
    if W * esz % 16 or base_ptr % 16 or max(bw, P, K) > MAX_BOX or smem > MAX_SMEM:
        return rows_config(N)
    return dict(route="tma", threads=THREADS, grid=max(1, min(N, blocks_per_sm * sm_count)),
                bw=bw, stage_bytes=stage_bytes, stages=STAGES, smem=smem)


_OCCUPANCY = {}     # (device index, threads, smem, element size) -> blocks per SM
_CONFIGS = {}       # (device index, shapes, dtype, aligned) -> device_per_env_config


def device_per_env_config(N: int, K: int, H: int, W: int, P: int, Pc: int, dtype: torch.dtype,
                          dev: torch.device, base_ptr: int = 0) -> dict:
    """`per_env_config` on card `dev`: its SM count and, for the "tma"
    route, the blocks that fit on one SM by the occupancy query (cached per
    device and shapes)."""
    key = (dev.index, N, K, H, W, P, Pc, dtype, base_ptr % 16 == 0)
    if key not in _CONFIGS:
        one = per_env_config(1, K, H, W, P, Pc, dtype, 1, 1, base_ptr)
        if one["route"] == "tma":
            k = (dev.index, one["threads"], one["smem"], _ESZ[dtype])
            if k not in _OCCUPANCY:
                blocks = _lib().window_dma_per_env_blocks_per_sm(*k[1:])
                if blocks <= 0:
                    raise RuntimeError(f"per_env_windows: occupancy query gave {blocks} blocks "
                                       f"per SM for {one}")
                _OCCUPANCY[k] = blocks
            sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
            _CONFIGS[key] = dict(per_env_config(N, K, H, W, P, Pc, dtype, sm_count,
                                                _OCCUPANCY[k], base_ptr),
                                 blocks_per_sm=_OCCUPANCY[k])
        else:
            _CONFIGS[key] = rows_config(N)
    return _CONFIGS[key]


def _lib():
    lib = build.load("window_dma")
    if lib.window_dma_per_env_launch.argtypes is None:
        lib.window_dma_per_env_launch.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 12 + [ctypes.c_void_p]
        lib.window_dma_per_env_launch.restype = ctypes.c_int
        lib.window_dma_per_env_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.window_dma_per_env_blocks_per_sm.restype = ctypes.c_int
        lib.window_dma_band_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        lib.window_dma_band_launch.restype = ctypes.c_int
    return lib


def _check(name: str, surfaces: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor):
    dev = surfaces.device
    if surfaces.dtype not in DTYPES or surfaces.dim() != 3 or not surfaces.is_contiguous():
        raise ValueError(f"{name}: the surfaces must be a contiguous 3-d float32 or bfloat16 "
                         f"tensor, got {surfaces.dtype} {tuple(surfaces.shape)}")
    for arg, t in (("x0", x0), ("y0", y0)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.shape != x0.shape:
            raise ValueError(f"{name}: {arg} must be a contiguous int32 (N,) tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launched(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def per_env_windows(G: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, P: int,
                    Pc: int = None) -> torch.Tensor:
    """D on the tensors' device: (N, K, P, Pc) windows of G (K, H, W) at
    (x0, y0) (int32 (N,)), zero outside G; Pc defaults to P.  On the card
    the route is `per_env_config`'s."""
    Pc = Pc or P
    dev = G.device
    if dev.type == "cpu":
        return per_env_windows_reference(G, x0, y0, P, Pc)
    if dev.type != "cuda":
        raise ValueError(f"per_env_windows: no kernel for device {dev}")
    _check("per_env_windows", G, x0, y0)
    K, H, W = G.shape
    N = x0.shape[0]
    out = torch.empty((N, K, P, Pc), dtype=G.dtype, device=dev)
    if N and P > 0 and Pc > 0:
        with torch.cuda.device(dev):
            cfg = device_per_env_config(N, K, H, W, P, Pc, G.dtype, dev, G.data_ptr())
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launched("per_env_windows", _lib().window_dma_per_env_launch(
                G.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(), N, K, H, W, P, Pc,
                G.element_size(), ROUTES.index(cfg["route"]), cfg["threads"], cfg["bw"],
                cfg["smem"], cfg["grid"], stream))
        per_env_windows.launches += 1
        per_env_windows.route_launches[cfg["route"]] += 1
    return out


def band_windows(G2: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, P: int, band: int,
                 stride: int, al: int) -> torch.Tensor:
    """E on the tensors' device: (N, P8, KB) slabs of the band stack G2
    (nb, Hp, KB) (`band_stack`) at JAX's clipped (x0a, yb); x0, y0 int32
    (N,)."""
    nb, Hp, KB = G2.shape
    P8 = -(-(P + al) // al) * al
    if Hp < P8 or KB < band or KB % 128 or stride < 1 or al < 1:
        raise ValueError(f"band_windows: a stack of {Hp} rows and {KB} lanes cannot hold "
                         f"slabs of {P8} rows of a {band}-column band (al {al}, stride {stride})")
    dev = G2.device
    if dev.type == "cpu":
        return band_windows_reference(G2, x0, y0, P, band, stride, al)
    if dev.type != "cuda":
        raise ValueError(f"band_windows: no kernel for device {dev}")
    _check("band_windows", G2, x0, y0)
    N = x0.shape[0]
    out = torch.empty((N, P8, KB), dtype=G2.dtype, device=dev)
    if N:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launched("band_windows", _lib().window_dma_band_launch(
                G2.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(), N, nb, Hp, KB, P8,
                stride, al, G2.element_size(), stream))
        band_windows.launches += 1
    return out


per_env_windows.launches = 0
per_env_windows.route_launches = dict.fromkeys(ROUTES, 0)
band_windows.launches = 0
