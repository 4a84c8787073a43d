"""The hand-written kernels K1 (contact LCP), K2 (terrain window), K3
(scandots) and D (the per-env window copy), timed on one card against the
same kernels of another checkout (the parent commit's), on the same inputs,
in turns.

    mkdir -p build/parent && git archive <parent> agility_tpu_torch | tar -x -C build/parent
    python3 kernel_bench.py --parent build/parent --trace    # needs one CUDA card
    python3 kernel_bench.py --kernels k2,k3                   # this checkout alone
    python3 kernel_bench.py --parent build/parent --kernels d

Builds every kernel, each from its own checkout's csrc/ into that checkout's
build/kernels/, makes the inputs as chip_smoke.py does (K1 at the BBC shape,
N = 4096, S = 24, and the TSC shape, N = 6144, S = 28 with ceiling rows
active, warm-started with 5 sweeps and cold with 10; K2 at the TSC shape,
N = 6144 windows of 32 on the 64-course world with weights and the
ceiling, and the BBC shape, N = 4096 windows of 24 on the rough grid; K3 at
the TSC shape, N = 6144 scans of 132 points, window 34; D at the window
A/B's three shapes, N = 6144 windows on the 1800 x 1800 world, float32 K 5
P 32 and bfloat16 K 3 P 56 and P 36, as chip_smoke.py's window DMA phase
makes them), holds every version to the plain one (K1 within 1e-4 of max
|lam|, K2, K3 and D exactly, D bit for bit), and times each four ways, in
the order parent, this, this, parent:
  warm_ms     chip_smoke.py's reading: CUDA events around one call, the L2
              warm across calls (includes the wrapper's host time where the
              card waits for it)
  lead_ms     the same with the card kept busy (torch.cuda._sleep) while the
              host enqueues the call: the kernel's own time, L2 warm
  flushed_ms  a 256 MB write before each call, so that the inputs come from
              device memory, the card kept busy while the host enqueues (the
              kernel's own time); the share of the bound is taken from it
  host_ms     the wrapper's own time on the host: the host clock over 40
              calls enqueued behind a sleeping card, per call, the median
              of 7 such batches
K2 is also timed in its other design, in the order parent, this, other,
other, this, parent: one block per env with plain loads (the route it takes
where W % 4 != 0); D likewise in its "rows" route (one block an env, row by
row: the route it takes where its tensor map is not allowed), forced on the
same grid.  D's rows give the bound (the distinct cells under the windows,
read once, the origins and the output), the share of it and the parent's
flushed time over this one's (speedup_flushed), as K1-K3's do.  With
--trace it also runs this checkout's K1 built with -DK1_TRACE and K2 built
with -DWINDOW_TRACE once per shape, flushed, and
reports where the blocks' time goes: when each block's first env landed
and when it ended (percentiles over the grid, ns from the first block's
start), and per env the ns a block spent waiting for its copy and computing
(K1: moving the stage into registers, sweeping; K2: folding, storing).
Prints one JSON line and writes it to chiprun_out/kernel_bench.json.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TRACE_BLOCKS, K1_SLOTS, WINDOW_SLOTS = 1024, 7, 7


def load_kernel(root: str, tag: str, name: str):
    """(kernels/<name> module, kernels/build module) of the checkout at
    `root`, the former bound to the latter (its csrc/, its build/kernels/)."""
    def load(mod, path):
        spec = importlib.util.spec_from_file_location(f"{tag}_{mod}", path)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        return m

    kdir = os.path.join(os.path.abspath(root), "agility_tpu_torch", "kernels")
    build = load("build", os.path.join(kdir, "build.py"))
    mod = load(name, os.path.join(kdir, f"{name}.py"))
    mod.build = build            # its _lib() looks `build` up when it is called
    return mod, build


def variant(name: str, tag: str, lib):
    """A copy of this checkout's kernels/<name> module whose kernel library
    is `lib` (a build with other macros)."""
    mod, _ = load_kernel(ROOT, tag, name)
    mod.build = types.SimpleNamespace(load=lambda *_: lib)
    return mod


def direct_k2():
    """This checkout's K2 module made to launch its one-block-per-env design
    (the route it takes where W % 4 != 0) on any grid."""
    mod, _ = load_kernel(ROOT, "direct", "terrain_window")

    def config(N, P, W, surfaces, dev):
        # the parameters of a grid one column wider: W % 4 != 0 takes the direct design
        return mod.launch_config(N, P, W + 1, surfaces, 1, 1)

    mod._config = config
    return mod


def rows_d():
    """This checkout's D module made to launch its "rows" route (one block an
    env, the route it takes where its tensor map is not allowed) on any
    grid."""
    mod, _ = load_kernel(ROOT, "rows", "window_dma")
    mod.device_per_env_config = lambda N, *_, **__: mod.rows_config(N)
    return mod


def read_trace(fn, read, grid, slots):
    """One flushed call of a traced kernel, then its per-block stamps
    (grid blocks, at most TRACE_BLOCKS) as an int64 array."""
    cs.cuda_ms(fn, reps=1, warmup=1, flush=True)
    buf = (ctypes.c_ulonglong * (TRACE_BLOCKS * slots))()
    if read(ctypes.cast(buf, ctypes.c_void_p)) != 0:
        raise SystemExit("kernel_bench: reading the trace failed")
    return np.array(buf, dtype=np.int64).reshape(TRACE_BLOCKS, slots)[:min(grid, TRACE_BLOCKS)]


def phases(t, names):
    """Percentiles of when blocks' first env landed and when they ended, and
    the ns per env of each accumulated phase (slots 3.. named `names`)."""
    start = t[:, 0].min()
    pct = lambda x: [float(np.percentile(x, p)) for p in (0, 10, 50, 90, 100)]
    envs = max(int(t[:, 6].sum()), 1)
    return dict(blocks=len(t), first_landed_ns=pct(t[:, 1] - start), end_ns=pct(t[:, 2] - start),
                per_env_ns={n: float(t[:, 3 + i].sum()) / envs for i, n in enumerate(names)})


def time_turns(row, versions, order, fn_of):
    """Warm, lead and flushed times of each version, in `order`."""
    for name in versions:
        row[name] = dict(warm_ms=[], lead_ms=[], flushed_ms=[], host_ms=[])
    for name in order:
        fn = fn_of(versions[name])
        r = row[name]
        r["warm_ms"].append(cs.cuda_ms(fn))
        r["lead_ms"].append(cs.lead_ms(fn))
        r["flushed_ms"].append(cs.cuda_ms(fn, flush=True))
        r["host_ms"].append(cs.host_ms(fn))
    for name in versions:
        row[name]["share"] = row["bound_ms"] / float(np.mean(row[name]["flushed_ms"]))
    if "parent" in versions:
        row["speedup_flushed"] = (float(np.mean(row["parent"]["flushed_ms"]))
                                  / float(np.mean(row["this"]["flushed_ms"])))


def with_variant(order, name):
    """`order` with this checkout's two turns made this, `name`, `name`,
    this."""
    inner = ["this", name, name, "this"]
    return order[:1] + inner + order[-1:] if order[0] == "parent" else inner


def summary(label, row, versions):
    return (f"{label}: bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            + "; ".join(f"{n} warm {row[n]['warm_ms']} lead {row[n]['lead_ms']} flushed "
                        f"{row[n]['flushed_ms']} host {row[n]['host_ms']} ms, share "
                        f"{100 * row[n]['share']:.1f}%"
                        for n in versions)
            + (f"; trace {row['trace']}" if "trace" in row else ""))


def bench_k1(opts, order, bbc, tsc):
    from agility_tpu_torch.kernels import contact_lcp as k1

    versions = {"this": k1}
    if opts.parent:
        versions["parent"], _ = load_kernel(opts.parent, "parent", "contact_lcp")
    if opts.trace:
        _, bt = load_kernel(ROOT, "traced", "contact_lcp")
        k1t = variant("contact_lcp", "traced", bt.load("contact_lcp", ("K1_TRACE",)))
    rows = {}
    for path, env, s, params in (("bbc", *bbc), ("tsc", *tsc)):
        for mode, warm, iters in (("warm", True, 5), ("cold", False, 10)):
            label = f"{path} {mode}"
            a = cs.k1_inputs(env, s, params, warm)
            kw = dict(iters=iters, relax=0.6)
            ref = k1.contact_lcp_reference(*a, **kw)
            N, M = a[1].shape
            bound_ms, by = cs.bound(cs.nbytes(*a, ref), 2 * iters * N * M * M)
            row = dict(N=N, S=M // 3, iters=iters, bytes=cs.nbytes(*a, ref), bound_ms=bound_ms,
                       bound_by=by, launch=k1.device_launch_config(N, M // 3, a[0].device))
            for name, mod in versions.items():
                out = mod.contact_lcp(*a, **kw)
                torch.cuda.synchronize()
                rel = float((out - ref).abs().max()) / float(ref.abs().max())
                if not rel <= cs.K1_RTOL:
                    raise SystemExit(f"K1 {label} ({name}): rel err {rel:.3e} over {cs.K1_RTOL}")
            time_turns(row, versions, order, lambda mod: lambda: mod.contact_lcp(*a, **kw))
            if opts.trace:
                t = read_trace(lambda: k1t.contact_lcp(*a, **kw),
                               k1t.build.load().contact_lcp_trace, row["launch"]["grid"], K1_SLOTS)
                row["trace"] = phases(t, ("wait", "load", "sweeps"))
            rows[label] = row
            print(summary(f"K1 {label} N={N} S={M // 3} iters={iters}", row, versions),
                  flush=True)
    return rows


def bench_k2(opts, order, bbc):
    from agility_tpu_torch.kernels import build
    from agility_tpu_torch.kernels import terrain_window as k2

    versions = {"this": k2, "direct": direct_k2()}
    if opts.parent:
        versions["parent"], _ = load_kernel(opts.parent, "parent", "terrain_window")
    if opts.trace:
        k2t = variant("terrain_window", "traced", build.load("terrain_window", ("WINDOW_TRACE",)))
    rows = {}
    for label, grid, c, size, w in cs.k2_cases(bbc):
        ref = k2.terrain_window_reference(grid, c, size, w)
        cells, sectors, names = cs.k2_reads(grid, ref, w)
        moved = cs.k2_moved(grid, c, w, ref, cells, names)
        bound_ms, by = cs.bound(moved)
        P = ref.values.shape[1]
        cfg = k2.device_launch_config(c.shape[0], P, grid, w, c.device)
        row = dict(N=c.shape[0], P=size, bytes=moved, cells=cells, sectors=sectors,
                   bound_ms=bound_ms, bound_by=by, launch=cfg,
                   direct_launch=versions["direct"].device_launch_config(c.shape[0], P, grid, w,
                                                                        c.device))
        if row["direct_launch"]["staged"]:
            raise SystemExit(f"K2 {label}: the direct variant would launch the staged design")
        fields = ("values", "x0", "y0") + (("ceil",) if ref.ceil is not None else ())
        for name, mod in versions.items():
            got = mod.terrain_window(grid, c, size, w)
            torch.cuda.synchronize()
            if not all(torch.equal(getattr(got, f), getattr(ref, f)) for f in fields):
                raise SystemExit(f"K2 {label} ({name}): differs from the plain version")
        time_turns(row, versions, with_variant(order, "direct"),
                   lambda mod: lambda: mod.terrain_window(grid, c, size, w))
        if opts.trace:
            t = read_trace(lambda: k2t.terrain_window(grid, c, size, w),
                           k2t.build.load().terrain_window_trace, cfg["grid"], WINDOW_SLOTS)
            row["trace"] = phases(t, ("wait", "fold", "store"))
        rows[label] = row
        print(summary(f"K2 {label} N={c.shape[0]} P={size} launch {cfg}", row, versions),
              flush=True)
    return rows


def bench_k3(opts, order):
    from agility_tpu_torch.kernels import scandots as k3

    versions = {"this": k3}
    if opts.parent:
        versions["parent"], _ = load_kernel(opts.parent, "parent", "scandots")
    args = cs.k3_case()
    g, sc, size, w, px, py = args
    ref = k3.scandots_reference(*args)
    cells, sectors, names, _ = cs.k3_reads(g, args)
    moved = cs.k3_moved(args, ref, cells, names)
    bound_ms, by = cs.bound(moved)
    N, K = px.shape
    cfg = k3.launch_config(N, K, size)
    row = dict(N=N, K=K, P=size, bytes=moved, cells=cells, sectors=sectors, bound_ms=bound_ms,
               bound_by=by, launch=cfg)
    for name, mod in versions.items():
        got = mod.scandots(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise SystemExit(f"K3 ({name}): differs from the plain version")
    time_turns(row, versions, order, lambda mod: lambda: mod.scandots(*args))
    print(summary(f"K3 tsc N={N} K={K} window {size} launch {cfg}", row, versions), flush=True)
    return {"tsc": row}


def bench_d(opts, order):
    from agility_tpu_torch.kernels import window_dma as wd
    from agility_tpu_torch.tools import bench_windows as bw

    versions = {"this": wd, "rows": rows_d()}
    if opts.parent:
        versions["parent"], _ = load_kernel(opts.parent, "parent", "window_dma")
    turns = with_variant(order, "rows")
    n = cs.WINDOW_ENVS
    x0, y0 = bw.origins(n, "cuda")
    rows = {}
    for dt, K, P, _ in bw.SHAPES:
        label = f"{dt} K{K} P{P}"
        g = bw.make_surfaces(K, bw.DTYPES[dt], "cuda")
        H, W = g.shape[1:]
        moved, cells = cs.d_moved(g, x0, y0, P)
        bound_ms, by = cs.bound(moved)
        row = dict(N=n, K=K, P=P, bytes=moved, cells=cells, bound_ms=bound_ms, bound_by=by,
                   order=turns, launch=wd.device_per_env_config(n, K, H, W, P, P, g.dtype,
                                                                g.device, g.data_ptr()))
        if row["launch"]["route"] != "tma":
            raise SystemExit(f"D {label}: this checkout would not take its \"tma\" route")
        ref = wd.per_env_windows_reference(g, x0, y0, P)
        for name, mod in versions.items():
            got = mod.per_env_windows(g, x0, y0, P)
            torch.cuda.synchronize()
            if not torch.equal(cs._bits(got), cs._bits(ref)):
                raise SystemExit(f"D {label} ({name}): differs from the plain version")
        time_turns(row, versions, turns, lambda mod: lambda: mod.per_env_windows(g, x0, y0, P))
        rows[label] = row
        print(summary(f"D {label} N={n} launch {row['launch']}", row, versions), flush=True)
        del g, ref
    return rows


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: torch.cuda.is_available() is false; this needs a CUDA card")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="k1,k2,k3,d", help="which of k1, k2, k3, d to time")
    ap.add_argument("--parent", help="a checkout whose kernels to time beside this one's")
    ap.add_argument("--trace", action="store_true", help="phase breakdown of this checkout's")
    opts = ap.parse_args()
    kernels = set(opts.kernels.split(","))
    if not kernels <= {"k1", "k2", "k3", "d"}:
        sys.exit(f"kernel_bench: --kernels takes k1, k2, k3, d; got {opts.kernels}")
    torch.backends.cuda.matmul.allow_tf32 = False
    from agility_tpu_torch.kernels import build

    names = dict(k1="contact_lcp", k2="terrain_window", k3="scandots", d="window_dma")
    builds = [("this", build)]
    if opts.parent:
        builds.append(("parent", load_kernel(opts.parent, "parent", "contact_lcp")[1]))
    for tag, b in builds:
        for k in sorted(kernels):
            b.load(names[k])
            print(f"ptxas {names[k]} ({tag}):\n"
                  f"{b.ptxas_info.get(names[k], 'already built').strip()}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = ["parent", "this", "this", "parent"] if opts.parent else ["this", "this"]
    result = dict(card=card, order=order)
    bbc = cs.bbc_case() if kernels & {"k1", "k2"} else None
    if "k1" in kernels:
        result["k1"] = bench_k1(opts, order, bbc, cs.tsc_case())
    if "k2" in kernels:
        result["k2"] = bench_k2(opts, order, bbc)
    if "k3" in kernels:
        result["k3"] = bench_k3(opts, order)
    if "d" in kernels:
        result["d"] = bench_d(opts, order)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_bench.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
