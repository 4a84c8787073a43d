"""D's design alternatives (csrc/window_dma.cu, route "tma"), timed on one
card in turns against this checkout's D, on the inputs of the window A/B.

    python3 window_dma_sweep.py     # needs one CUDA card

Each alternative is a copy of this checkout's csrc/ with one change, built
into build/window_dma_sweep/<name>/:
  stages3, stages4  the ring with 3 or 4 stages (D: 2; fewer blocks an SM)
  prom_none         the tensor map's L2 promotion none (D: 128 B)
  prom_256          the same, 256 B
  plain_st          plain stores of the output (D: st.global.cs)
  last              the box loads with an L2 evict-last hint (fraction 1)
At the window A/B's three shapes (N = 6144 windows on the 1800 x 1800 world,
float32 K 5 P 32 and bfloat16 K 3 P 56 and P 36, as kernel_bench.py
--kernels d makes them), every version is held bit for bit to the plain
version, then timed in the order this, stages3, stages4, prom_none,
prom_256, plain_st, last, and back, two ways a turn:
  flushed_ms  chip_smoke.py's reading: a 256 MB buffer written before each
              call, CUDA events around the call
  reset_ms    the same, with every line of the surfaces set back to the
              L2's normal eviction priority (applypriority) before the
              256 MB write: a line that `last` loaded with its evict-last
              hint outlives that write, so without the reset whatever runs
              after `last` reads the surfaces partly from the L2
Prints the card, one line a shape, and one JSON line, which it also writes
to chiprun_out/window_dma_sweep.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import kernel_bench as kb  # noqa: E402

OUT = os.path.join(ROOT, "build", "window_dma_sweep")
LOAD_3D = ('"cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
           '      " [%0], [%1, {%2, %3, %4}], [%5];\\n"')
LOAD_3D_LAST = ('"{\\n.reg .b64 pol;\\n'
                'createpolicy.fractional.L2::evict_last.b64 pol, 0f3F800000;\\n"\n'
                '      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx'
                '::bytes.L2::cache_hint"\n'
                '      " [%0], [%1, {%2, %3, %4}], [%5], pol;\\n}\\n"')
STAGES_2 = "constexpr int kStagesD = 2;"
PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"
INCLUDE = '#include "window_ring.cuh"\n'
# name: ([(file in csrc/, text, its replacement)], module attributes)
VARIANTS = {
    "stages3": ([("window_dma.cu", STAGES_2, STAGES_2.replace("2", "3"))],
                dict(STAGES=3, BARRIER_BYTES=48)),
    "stages4": ([("window_dma.cu", STAGES_2, STAGES_2.replace("2", "4"))],
                dict(STAGES=4, BARRIER_BYTES=64)),
    "prom_none": ([("window_ring.cuh", PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_NONE")], {}),
    "prom_256": ([("window_ring.cuh", PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")], {}),
    "plain_st": ([("window_dma.cu", INCLUDE, INCLUDE + "#define __stcs(p, v) (*(p) = (v))\n")],
                 {}),
    "last": ([("window_ring.cuh", LOAD_3D, LOAD_3D_LAST)], {}),
}
L2_NORMAL = r"""
// Every 128-byte line of [p, p + lines * 128) that is in the L2 back to the
// normal eviction priority.
__global__ void l2_normal_kernel(const char* p, long long lines) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < lines;
       i += (long long)gridDim.x * blockDim.x)
    asm volatile("applypriority.L2::evict_normal [%0], 128;\n" ::"l"(p + i * 128) : "memory");
}

extern "C" int l2_normal(const void* p, long long bytes, void* stream) {
  l2_normal_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>((const char*)p, (bytes + 127) / 128);
  return (int)cudaGetLastError();
}
"""


def make_variant(name: str) -> str:
    """A copy of this checkout's kernels/ and csrc/ with `name`'s changes;
    returns its root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    for d in ("kernels", "csrc"):
        shutil.copytree(os.path.join(ROOT, "agility_tpu_torch", d),
                        os.path.join(root, "agility_tpu_torch", d))
    for fname, text, new in VARIANTS[name][0]:
        path = os.path.join(root, "agility_tpu_torch", "csrc", fname)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise SystemExit(f"window_dma_sweep: {name}: {text!r} is not in {fname} once")
        with open(path, "w") as f:
            f.write(src.replace(text, new))
    return root


def build_l2_normal(build) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "l2_normal.cu"), os.path.join(OUT, "l2_normal.so")
    with open(src, "w") as f:
        f.write(L2_NORMAL)
    flags = [x for x in build.NVCC_FLAGS if x not in ("-Xptxas", "-v")]
    res = subprocess.run([build._nvcc(), *flags, "-o", lib, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"window_dma_sweep: nvcc failed on l2_normal.cu:\n{res.stderr}")
    dll = ctypes.CDLL(lib)
    dll.l2_normal.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    dll.l2_normal.restype = ctypes.c_int
    return dll


def reset_flushed_ms(fn, reset, reps=30, warmup=5):
    """cs.cuda_ms(fn, flush=True) with reset() enqueued before each write of
    the flush buffer."""
    buf = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        reset()
        buf.fill_(1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        sys.exit("window_dma_sweep: torch.cuda.is_available() is false; this needs a CUDA card")
    from agility_tpu_torch.kernels import build
    from agility_tpu_torch.kernels import window_dma as wd
    from agility_tpu_torch.tools import bench_windows as bw

    versions = {"this": (wd, build)}
    for name in VARIANTS:
        versions[name] = kb.load_kernel(make_variant(name), name, "window_dma")
        for attr, value in VARIANTS[name][1].items():
            setattr(versions[name][0], attr, value)
    with ThreadPoolExecutor(len(versions) + 1) as pool:     # one nvcc a build, all at once
        l2 = pool.submit(build_l2_normal, build)
        for f in [pool.submit(b.load, "window_dma") for _, b in versions.values()]:
            f.result()
        l2 = l2.result()
    mods = {name: m for name, (m, _) in versions.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    turns = list(mods) + list(mods)[::-1]
    n = cs.WINDOW_ENVS
    x0, y0 = bw.origins(n, "cuda")
    result = dict(card=card, order=turns, shapes={})
    for dt, K, P, _ in bw.SHAPES:
        label = f"{dt} K{K} P{P}"
        g = bw.make_surfaces(K, bw.DTYPES[dt], "cuda")
        H, W = g.shape[1:]
        stream = lambda: torch.cuda.current_stream().cuda_stream

        def reset():
            if l2.l2_normal(g.data_ptr(), g.numel() * g.element_size(), stream()) != 0:
                raise SystemExit("window_dma_sweep: l2_normal did not launch")

        moved, _ = cs.d_moved(g, x0, y0, P)
        bound_ms, _ = cs.bound(moved)
        ref = cs._bits(wd.per_env_windows_reference(g, x0, y0, P))
        row = dict(bound_ms=bound_ms)
        for name, mod in mods.items():
            cfg = mod.device_per_env_config(n, K, H, W, P, P, g.dtype, g.device, g.data_ptr())
            before = mod.per_env_windows.route_launches["tma"]
            same = torch.equal(cs._bits(mod.per_env_windows(g, x0, y0, P)), ref)
            if not same or cfg["route"] != "tma" or \
                    mod.per_env_windows.route_launches["tma"] != before + 1:
                raise SystemExit(f"window_dma_sweep: {label} {name}: not bit-exact on \"tma\"")
            row[name] = dict(launch=cfg, flushed_ms=[], reset_ms=[])
        for name in turns:
            fn = lambda: mods[name].per_env_windows(g, x0, y0, P)
            row[name]["flushed_ms"].append(cs.cuda_ms(fn, flush=True))
            row[name]["reset_ms"].append(reset_flushed_ms(fn, reset))
        reset()
        torch.cuda.synchronize()
        result["shapes"][label] = row
        print(f"D {label}: bound {bound_ms:.4f} ms; " + "; ".join(
            f"{name} (stages {row[name]['launch']['stages']}, grid {row[name]['launch']['grid']}) "
            f"flushed {[round(t, 4) for t in row[name]['flushed_ms']]} reset "
            f"{[round(t, 4) for t in row[name]['reset_ms']]}" for name in mods), flush=True)
        del g, ref
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "window_dma_sweep.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
