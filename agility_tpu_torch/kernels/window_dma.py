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

Out of range: the TPU's DMA reads D's window wherever (x0, y0) puts it.
Here nothing reads outside G: a window cell whose row is outside [0, H) or
whose column is outside [0, W) is zero, in the kernel and the plain
version alike.  E's clips keep every slab inside G2 (the wrappers require
Hp >= P8).

Each wrapper dispatches on the tensors' device alone: CPU tensors take the
plain version; CUDA tensors launch the kernel, or raise.  Each launch adds
one to `per_env_windows.launches` / `band_windows.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from agility_tpu_torch.kernels import build

TPU_KERNEL_D = "tools/bench_windows.py:214"   # pallas_windows; kernel :224, pallas_call :262
TPU_KERNEL_E = "tools/bench_windows.py:144"   # pallas_band_dma; kernel :169, pallas_call :200
SOURCE = "agility_tpu_torch/csrc/window_dma.cu"
DTYPES = (torch.float32, torch.bfloat16)


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


def _lib():
    lib = build.load("window_dma")
    if lib.window_dma_per_env_launch.argtypes is None:
        lib.window_dma_per_env_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        lib.window_dma_per_env_launch.restype = ctypes.c_int
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
    (x0, y0) (int32 (N,)), zero outside G; Pc defaults to P."""
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
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launched("per_env_windows", _lib().window_dma_per_env_launch(
                G.data_ptr(), x0.data_ptr(), y0.data_ptr(), out.data_ptr(), N, K, H, W, P, Pc,
                G.element_size(), stream))
        per_env_windows.launches += 1
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
band_windows.launches = 0
