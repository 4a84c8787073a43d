"""Per-env terrain-window extraction formulations on one card (counterpart
of the JAX package's tools/bench_windows.py, an A/B of the window
extraction on the TSC course world's shapes):

  A  banded gather (H, nb, band, K) + one-hot contraction
  B  K-leading banded gather (K, H, nb, band) + one-hot contraction
  C  lane-concat bands (H, nb, K*band) + per-surface slices + contraction
  D  per-env window copy at the exact origin: kernels/window_dma.per_env_windows
  E  band-stack slab copy at the aligned origin: kernels/window_dma.band_windows

A, B and C are plain torch (the gather, then the one-hot contraction with
the one-hot in the rows' dtype: it selects, so it is exact); D and E run
through the hand-written kernels (csrc/window_dma.cu).

    python -m agility_tpu_torch.tools.bench_windows          # BENCH_ENVS=6144, one card
    BENCH_ENVS=8 python -m agility_tpu_torch.tools.bench_windows --device cpu

The JAX tool's setup: a 1800 x 1800 world, N = BENCH_ENVS envs, surfaces
N(0, 0.3) from default_rng(1), origins from default_rng(0) in [0, 1720),
T = 24 steps a run with the output's sum fed back into the origins (so no
step can be skipped), 3 timed runs of each row; its check_band_dma (E
against direct slicing) runs first.  Shapes: float32 K 5, P 32 (band 64,
stride 32) and bfloat16 K 3, P 56 (stride 8) and P 36 (stride 16).  Every
formulation gets a row at every shape.  The JAX tool sweeps E's EB, the
envs a TPU grid step copies; that is a TPU block size with no counterpart
here (one block an env), so E has one row a shape.  The 3 timed runs are
interleaved rounds over a shape's rows (tools/timing.py).  Prints ms a
step per row (median, min, max), and the window kernels' launches a step.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from agility_tpu_torch.kernels import window_dma
from agility_tpu_torch.tools import timing

H = W = 1800          # TSC course world at 0.05 m
N = int(os.environ.get("BENCH_ENVS", "6144"))
T = 24                # steps per timed run (the rollout's length)
ITERS = 3             # timed runs of each row
BAND = 64
# (dtype, K, P, stride) of each shape, in the JAX tool's order
SHAPES = (("f32", 5, 32, 32), ("bf16", 3, 56, 8), ("bf16", 3, 36, 16))
DTYPES = dict(f32=torch.float32, bf16=torch.bfloat16)


def make_surfaces(K, dtype, device, H=H, W=W):
    """K surfaces N(0, 0.3) from default_rng(1), cast as the JAX tool does."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(0, 0.3, (K, H, W)).astype(np.float32))
    return g.to(device=device, dtype=dtype)


def origins(n, device, seed=0, H=H, W=W):
    """x0, y0 int32 (n,) in [0, H - 80) and [0, W - 80), from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.integers(0, H - 80, n), dtype=torch.int32, device=device)
    y0 = torch.as_tensor(rng.integers(0, W - 80, n), dtype=torch.int32, device=device)
    return x0, y0


def _bands(R, nb, reps, dim):
    """The overlapping bands: `reps` shifted views of R's stride blocks side by side."""
    return torch.cat([R.narrow(dim - 1, i, nb) for i in range(reps)], dim=dim)


def _geometry(W_, P, band, stride):
    nb = max((W_ - P) // stride + 1, 1)
    return nb, (nb - 1) * stride + band


def _select(off, P, band, dtype):
    """(N, band, P) one-hot of window column q at band column off + q."""
    iy = off[:, None, None] + torch.arange(P, device=off.device)[None, None, :]
    return (torch.arange(band, device=off.device)[None, :, None] == iy).to(dtype)


def _band_origin(x0, y0, P, nb, stride):
    yb = torch.clamp(torch.div(y0, stride, rounding_mode="floor"), 0, nb - 1)
    ix = x0.long()[:, None] + torch.arange(P, device=x0.device)
    return yb.long(), (y0 - yb * stride).long(), ix


def banded_gather(Gs_hwk, P, band, stride):
    """A: bands (H, nb, band, K); the rows (N, P, band, K) gathered, then
    contracted with the one-hot: (N, P, P, K)."""
    Hh, Ww, K = Gs_hwk.shape
    nb, Wp = _geometry(Ww, P, band, stride)
    Gp = torch.nn.functional.pad(Gs_hwk, (0, 0, 0, max(Wp - Ww, 0)))
    G2 = _bands(Gp.reshape(Hh, Wp // stride, stride, K), nb, band // stride, 2)

    def fn(x0, y0):
        yb, off, ix = _band_origin(x0, y0, P, nb, stride)
        rows = G2[ix, yb[:, None]]                            # (N, P, band, K)
        return torch.einsum("npjk,njq->npqk", rows, _select(off, P, band, rows.dtype))
    return fn


def banded_gather_kfirst(Gs_khw, P, band, stride):
    """B: bands (K, H, nb, band); rows (K, N, P, band); out (K, N, P, P)."""
    K, Hh, Ww = Gs_khw.shape
    nb, Wp = _geometry(Ww, P, band, stride)
    Gp = torch.nn.functional.pad(Gs_khw, (0, max(Wp - Ww, 0)))
    G2 = _bands(Gp.reshape(K, Hh, Wp // stride, stride), nb, band // stride, 3)

    def fn(x0, y0):
        yb, off, ix = _band_origin(x0, y0, P, nb, stride)
        rows = G2[:, ix, yb[:, None]]                         # (K, N, P, band)
        return torch.einsum("knpj,njq->knpq", rows, _select(off, P, band, rows.dtype))
    return fn


def banded_gather_laneconcat(Gs_khw, P, band, stride):
    """C: the surfaces' bands side by side along the lanes (H, nb, K*band):
    one gather of (N, P, K*band), each surface's lanes contracted; out
    (N, P, P, K)."""
    K, Hh, Ww = Gs_khw.shape
    nb, Wp = _geometry(Ww, P, band, stride)
    Gp = torch.nn.functional.pad(Gs_khw, (0, max(Wp - Ww, 0)))
    G2 = _bands(Gp.reshape(K, Hh, Wp // stride, stride), nb, band // stride, 3)
    G2 = torch.cat([G2[k] for k in range(K)], dim=-1)         # (H, nb, K*band)

    def fn(x0, y0):
        yb, off, ix = _band_origin(x0, y0, P, nb, stride)
        rows = G2[ix, yb[:, None]]                            # (N, P, K*band)
        oh = _select(off, P, band, rows.dtype)
        return torch.stack([torch.einsum("npj,njq->npq", rows[..., k * band:(k + 1) * band], oh)
                            for k in range(K)], -1)
    return fn


def band_dma(Gs_khw, P, band, stride):
    """E: the band stack built once (window_dma.band_stack), then one slab
    copy per env through the kernel: (N, P8, KB)."""
    al = window_dma.sublane(Gs_khw.dtype)
    G2 = window_dma.band_stack(Gs_khw, P, band, stride, al)
    return lambda x0, y0: window_dma.band_windows(G2, x0, y0, P, band, stride, al)


def per_env_dma(Gs_khw, P, Pc=None):
    """D: one window copy per env at its exact origin: (N, K, P, Pc)."""
    return lambda x0, y0: window_dma.per_env_windows(Gs_khw, x0, y0, P, Pc)


def run_steps(fn, x0, y0, T=T):
    """T steps of fn, each step's output summed and its parity added to the
    origins of the next (the JAX tool's feedback).  Returns the sum."""
    acc = torch.zeros((), dtype=torch.float32, device=x0.device)
    for _ in range(T):
        s = fn(x0, y0).float().sum()
        bump = s.to(torch.int32) & 1
        x0, y0, acc = x0 + bump, y0 + bump, acc + s
    return acc


def check_band_dma(device, n=N, H=H, W=W):
    """E's slabs against direct slicing of the surfaces (the JAX tool's
    check_band_dma, the same envs: 0, 1, 17 and the last)."""
    K, P, band, stride = 5, 32, 64, 32
    g = make_surfaces(K, torch.float32, device, H, W)
    out = band_dma(g, P, band, stride)(*origins(n, device, 7, H, W))
    x0, y0 = (t.cpu() for t in origins(n, "cpu", 7, H, W))
    out, g = out.cpu(), g.cpu()
    for i in sorted({0, 1, 17, n - 1} & set(range(n))):
        x0a = min((int(x0[i]) // 8) * 8, H - out.shape[1])
        c0 = min(int(y0[i]) // stride, (W - P) // stride) * stride
        for k in range(K):
            ref = g[k, x0a:x0a + out.shape[1], c0:c0 + band]
            got = out[i, :, k * band:(k + 1) * band]
            if not torch.equal(got[:ref.shape[0], :ref.shape[1]], ref):
                raise SystemExit(f"E numerics: env {i} surface {k} differs from direct slicing")
    print("E numerics: OK", flush=True)


def formulations(dtype, K, P, stride, device, H=H, W=W):
    """(label, fn) of every row at one shape; the labels of A, C and E are
    the JAX tool's (E without its EB)."""
    g = make_surfaces(K, DTYPES[dtype], device, H, W)
    g_hwk = g.permute(1, 2, 0).contiguous()
    a_label = f"A banded (H,nb,band,K) f32 K{K} P{P}" if dtype == "f32" else \
        f"A banded bf16 K{K} P{P}"
    return [(a_label, banded_gather(g_hwk, P, BAND, stride)),
            (f"B K-leading (K,H,nb,band) {dtype} K{K} P{P}",
             banded_gather_kfirst(g, P, BAND, stride)),
            (f"C lane-concat {dtype} K{K} P{P}", banded_gather_laneconcat(g, P, BAND, stride)),
            (f"D per-env window DMA {dtype} K{K} P{P}", per_env_dma(g, P)),
            (f"E band DMA {dtype} K{K} P{P}", band_dma(g, P, BAND, stride))]


def bench(device, n=N, T=T, iters=ITERS, shapes=SHAPES, H=H, W=W):
    """check_band_dma, then every shape's rows timed in `iters` interleaved
    rounds of T steps each (fresh origins each run, as the JAX tool's scan
    starts from them).  Returns the rows (timing.interleaved's, plus dtype,
    K, P)."""
    check_band_dma(device, n, H, W)
    x0, y0 = origins(n, device, 0, H, W)
    rows = []
    for dtype, K, P, stride in shapes:
        fns = formulations(dtype, K, P, stride, device, H, W)
        with torch.no_grad():
            got = timing.interleaved(
                [timing.Variant(label, (lambda fn=fn: run_steps(fn, x0, y0, T)), per=T)
                 for label, fn in fns], device, iters)
        for r in got:
            r.update(dtype=dtype, K=K, P=P)
            print(f"{r['label']:44s} {r['ms']:8.3f} ms/step [{r['ms_min']:.3f}, "
                  f"{r['ms_max']:.3f}]  window kernels a step: D "
                  f"{r['launches']['per_env_windows']:g}, E {r['launches']['band_windows']:g}",
                  flush=True)
        rows += got
        del fns
    return rows


def main(argv=None):
    from agility_tpu_torch.bench import device_label

    p = argparse.ArgumentParser(description="window-extraction formulations on one card")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    label = device_label(device)
    print(f"N={N}, world {H}x{W} on {label}", flush=True)
    rows = bench(device)
    print(json.dumps({"device": label, "num_envs": N, "T": T, "iters": ITERS, "rows": rows}))


if __name__ == "__main__":
    main()
