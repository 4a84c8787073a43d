"""K1, the contact LCP kernel, timed on one card against the same kernel of
another checkout (the parent commit's), on the same inputs, in turns.

    mkdir -p build/parent && git archive <parent> agility_tpu_torch | tar -x -C build/parent
    python3 k1_bench.py --parent build/parent      # needs one CUDA card

Builds both kernels, each from its own checkout's csrc/ into that checkout's
build/kernels/, makes K1's inputs as chip_smoke.py does (the BBC shape,
N = 4096, S = 24, and the TSC shape, N = 6144, S = 28 with ceiling rows
active), holds both kernels to the plain version (1e-4 of max |lam|), and
times each warm-started (5 sweeps) and cold (10 sweeps) three ways, in the
order parent, this, this, parent:
  warm_ms     chip_smoke.py's reading: CUDA events around one call, the L2
              warm across calls (includes the wrapper's host time where the
              card waits for it)
  lead_ms     the same with the card kept busy (torch.cuda._sleep) while the
              host enqueues the call: the kernel's own time, L2 warm
  flushed_ms  a 256 MB write before each call, so that the inputs come from
              device memory; the share of the bound is taken from it
Without --parent it times this checkout's kernel alone.  With --trace it also
runs this checkout's kernel built with -DK1_TRACE once per shape, flushed, and
reports where its blocks' time goes: when each block's first env landed and
when it ended (percentiles over the grid, ns from the first block's start),
and per env the ns a block spent waiting for the copy, loading the stage into
registers and issuing the next copy, and sweeping.  Prints one JSON line and
writes it to chiprun_out/k1_bench.json.
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


def load_k1(root: str, tag: str):
    """The kernels/contact_lcp module of the checkout at `root`, bound to that
    checkout's own kernels/build.py (its csrc/, its build/kernels/)."""
    def load(name, path):
        spec = importlib.util.spec_from_file_location(f"{tag}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    kdir = os.path.join(os.path.abspath(root), "agility_tpu_torch", "kernels")
    build = load("build", os.path.join(kdir, "build.py"))
    k1 = load("contact_lcp", os.path.join(kdir, "contact_lcp.py"))
    k1.build = build            # its _lib() looks `build` up when it is called
    return k1, build


def lead_ms(fn, reps=30, warmup=5):
    """Median milliseconds of fn() on the card with the card busy while the
    host enqueues it, so the events time the kernel and not the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def trace_phases(k1t, lib, args, kw):
    """One flushed call of the traced kernel (module k1t, library lib) and
    the phase breakdown of its blocks."""
    cs.cuda_ms(lambda: k1t.contact_lcp(*args, **kw), reps=1, warmup=1, flush=True)
    N, M = args[1].shape
    grid = k1t.device_launch_config(N, M // 3, args[0].device)["grid"]
    buf = (ctypes.c_ulonglong * (1024 * 7))()
    if lib.contact_lcp_trace(ctypes.cast(buf, ctypes.c_void_p)) != 0:
        raise SystemExit("k1_bench: reading the trace failed")
    t = np.array(buf, dtype=np.int64).reshape(1024, 7)[:min(grid, 1024)]
    start = t[:, 0].min()
    pct = lambda x: [float(np.percentile(x, p)) for p in (0, 10, 50, 90, 100)]
    envs = t[:, 6].sum()
    return dict(blocks=len(t), first_landed_ns=pct(t[:, 1] - start), end_ns=pct(t[:, 2] - start),
                per_env_ns=dict(wait=t[:, 3].sum() / envs, load=t[:, 4].sum() / envs,
                                sweeps=t[:, 5].sum() / envs))


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_bench: torch.cuda.is_available() is false; this needs a CUDA card")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose K1 to time beside this one's")
    ap.add_argument("--trace", action="store_true", help="phase breakdown of this K1")
    opts = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from agility_tpu_torch.kernels import build
    from agility_tpu_torch.kernels import contact_lcp as k1

    versions, builds = {"this": k1}, {"this": build}
    if opts.parent:
        versions["parent"], builds["parent"] = load_k1(opts.parent, "parent")
    for name, b in builds.items():
        b.load("contact_lcp")
        print(f"ptxas ({name}):\n{b.ptxas_info.get('contact_lcp', 'already built').strip()}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = ["parent", "this", "this", "parent"] if opts.parent else ["this", "this"]
    if opts.trace:
        k1t, bt = load_k1(ROOT, "traced")
        trace_lib = bt.load("contact_lcp", ("K1_TRACE",))
        k1t.build = types.SimpleNamespace(load=lambda name: trace_lib)

    rows = {}
    for path, env, s, params in (("bbc", *cs.bbc_case()), ("tsc", *cs.tsc_case())):
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
                row[name] = dict(rel_err=rel, warm_ms=[], lead_ms=[], flushed_ms=[])
            for name in order:
                fn = lambda mod=versions[name]: mod.contact_lcp(*a, **kw)
                r = row[name]
                r["warm_ms"].append(cs.cuda_ms(fn))
                r["lead_ms"].append(lead_ms(fn))
                r["flushed_ms"].append(cs.cuda_ms(fn, flush=True))
            for name in versions:
                r = row[name]
                r["share"] = bound_ms / float(np.mean(r["flushed_ms"]))
            if opts.trace:
                row["trace"] = trace_phases(k1t, trace_lib, a, kw)
            if opts.parent:
                row["speedup_flushed"] = (float(np.mean(row["parent"]["flushed_ms"]))
                                          / float(np.mean(row["this"]["flushed_ms"])))
            rows[label] = row
            print(f"K1 {label}: N={N} S={M // 3} iters={iters}, bound {bound_ms:.4f} ms ({by}); "
                  + "; ".join(f"{name} warm {r['warm_ms']} lead {r['lead_ms']} flushed "
                              f"{r['flushed_ms']} ms, share {100 * r['share']:.1f}%"
                              for name, r in ((n, row[n]) for n in versions))
                  + (f"; trace {row['trace']}" if opts.trace else ""), flush=True)
    result = dict(card=card, order=order, k1=rows)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_bench.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
