"""The benchmark's own arithmetic: the chip's peaks, percentiles, the device's
busy time as a union of intervals, K1's bound bytes, the networks' FLOPs,
and the aggregation of a profiled slice by kernel name.

Copies of sound pieces of the program's tooling live here, so that later
changes to the program cannot move the yardstick:
  * `aggregate` follows agility_tpu_torch/tools/trace_agg.py:aggregate
    (device events by name, a trailing ".<number>" stripped), reading the
    profiler's events in memory instead of a chrome trace file;
  * `nbytes` and `bound_s` follow chip_smoke.py's nbytes / bound (inputs read
    once, outputs written once, over the HBM's bytes per second or the
    float32 peak, the larger).
"""
from __future__ import annotations

import collections
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores: TF32 is off in the program


def percentile_nearest_rank(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by half-open intervals [start, end); overlaps
    count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The uncovered stretches between the union's pieces, in time order."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def nbytes(shapes: Iterable[Sequence[int]], itemsize: int = 4) -> int:
    """Bytes of tensors of the given shapes, each read or written once."""
    return sum(itemsize * math.prod(s) for s in shapes)


def bound_s(moved: float, flops: float = 0.0) -> Tuple[float, str]:
    """(seconds, what bounds it): the least time the chip could take to move
    `moved` bytes and do `flops` float32 operations."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes(N: int, S: int) -> int:
    """K1's bound bytes for N envs of S contacts (M = 3S rows), from the shapes
    alone: G (N, M, M), vf, bias, n, lam0 (N, M), act, mu (N, S), dinv
    (N, S, 9) read once, lam (N, M) written once, all float32."""
    M = 3 * S
    return nbytes([(N, M, M), (N, M), (N, M), (N, M), (N, S), (N, S, 9), (N, S), (N, M),
                   (N, M)])


def linear_flops(rows: int, fan_in: int, fan_out: int) -> int:
    """Multiply-adds of a dense layer over `rows` rows, counted as 2 FLOPs."""
    return 2 * rows * fan_in * fan_out


def conv1d_flops(batch: int, c_in: int, c_out: int, kernel: int, l_out: int,
                 groups: int = 1) -> int:
    """Multiply-adds of a 1-d convolution, counted as 2 FLOPs."""
    return 2 * batch * c_out * l_out * (c_in // groups) * kernel


def train_flops(forward: float, forward_with_grad: float) -> float:
    """Model FLOPs: the forward calls without gradients, and those whose
    parameters take gradients with a backward of twice their forward."""
    return forward + 3.0 * forward_with_grad


def share_pct(numerator: float, denominator: float) -> Optional[float]:
    """100 * numerator / denominator, or None where there is nothing to read."""
    if not denominator or denominator <= 0 or numerator is None:
        return None
    return 100.0 * numerator / denominator


_NUM_SUFFIX = re.compile(r"\.\d+$")


def aggregate(device_events: Iterable[Tuple[str, float, float]]) -> Dict:
    """{total_s, count, s: Counter, calls: Counter} of device events given as
    (name, start_s, duration_s), by name (trace_agg's rule)."""
    secs, calls = collections.Counter(), collections.Counter()
    for name, _, dur in device_events:
        name = _NUM_SUFFIX.sub("", name)
        secs[name] += dur
        calls[name] += 1
    return dict(total_s=sum(secs.values()), count=sum(calls.values()), s=secs, calls=calls)
