"""Aggregate a torch.profiler chrome trace by kernel name (counterpart of
the JAX package's tools/trace_agg.py, which reads jax.profiler traces):
device milliseconds and calls per name, the total, and the top 40.

    python -m agility_tpu_torch.tools.trace_agg chiprun_out/tsc_trace.json

The trace is a file written by torch.profiler's export_chrome_trace (as
tools/bench_tsc.py's BENCH_PROFILE writes it; .json or .json.gz) or a
directory, whose newest such file is read.  The device's events are the
complete ("X") events of the categories kernel, gpu_memcpy and gpu_memset;
a trace without any (a CPU-only run) is aggregated over its host
operators (category cpu_op) instead, and the line says so.  Names lose a
trailing ".<number>", as the JAX tool strips XLA's fusion numbering.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op",)
TOP = 40


def load(path: str) -> list:
    """The trace's events, from a file or the newest trace file of a directory."""
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "*.json")) + glob.glob(
            os.path.join(path, "*.json.gz"))
        if not files:
            raise SystemExit(f"no trace under {path}")
        path = max(files, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def aggregate(events: list) -> dict:
    """{total_ms, count, ms: Counter, calls: Counter, categories} over the
    device's events, or the host operators' where the trace has none."""
    xs = [e for e in events if e.get("ph") == "X"]
    cats = DEVICE if any(e.get("cat") in DEVICE for e in xs) else HOST
    ms, calls = collections.Counter(), collections.Counter()
    for e in xs:
        if e.get("cat") in cats:
            name = re.sub(r"\.\d+$", "", e["name"])
            ms[name] += e.get("dur", 0) / 1e3
            calls[name] += 1
    return dict(total_ms=sum(ms.values()), count=sum(calls.values()), ms=ms, calls=calls,
                categories=cats)


def main(argv=None):
    p = argparse.ArgumentParser(description="aggregate a torch.profiler trace by kernel name")
    p.add_argument("trace", help="a chrome trace (.json, .json.gz) or a directory of them")
    agg = aggregate(load(p.parse_args(argv).trace))
    where = "device" if agg["categories"] == DEVICE else "host operator (no device events)"
    print(f"total {where} time: {agg['total_ms']:.1f} ms over {agg['count']} ops")
    for name, ms in agg["ms"].most_common(TOP):
        print(f"{ms:9.2f} ms  x{agg['calls'][name]:<5} {name[:110]}")
    return agg


if __name__ == "__main__":
    main()
