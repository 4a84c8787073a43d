"""The per-layer readers that `benchmark/metrics/<metric>.py` name: each
takes a traced run's readings and returns the metric, or None where the
run holds nothing to read (the harness then leaves the metric out)."""
from __future__ import annotations

from statistics import mean
from typing import Dict, Optional

from benchmark.harness import yardstick as ys


def update_ms(r: Dict) -> Optional[float]:
    """Mean ms per window iteration from the trainer's "rollout" mark to the
    last stage mark before the runner's "end" (GAE, PPO, the disc and, where
    the iteration runs it, DAgger)."""
    vals = []
    for st in r.get("stages", []):
        order = [s for s in st["_order"] if s != "end"]
        if "rollout" not in order:
            continue
        after = order[order.index("rollout") + 1:]
        if after:
            vals.append(sum(st[s] for s in after))
    return mean(vals) if vals else None


def rollout_step_ms(r: Dict) -> Optional[float]:
    """Mean ms of the "rollout" stage (from the mark before it) over the
    steps per iteration."""
    vals = [st["rollout"] for st in r.get("stages", []) if "rollout" in st]
    return mean(vals) / r["steps_per_iteration"] if vals else None


def engine_ms(r: Dict) -> Optional[float]:
    """Mean ms of the span around physics/engine.py:step_batch, per control step."""
    vals = r.get("engine_ms")
    return mean(vals) if vals else None


def policy_ms(r: Dict) -> Optional[float]:
    """Mean ms of the span around the policy's call, per control step."""
    vals = r.get("policy_ms")
    return mean(vals) if vals else None


def k1_roofline(r: Dict) -> Optional[float]:
    """K1's bound time from its shapes alone (bytes over the HBM's rate) over
    its mean device time in the profiled slice, in %."""
    sl = r.get("slice")
    if not sl or not sl["k1_s"] or not sl["k1_shape"]:
        return None
    bound, _ = ys.bound_s(ys.k1_bytes(*sl["k1_shape"]))
    return ys.share_pct(bound, mean(sl["k1_s"]))


def device_idle(r: Dict) -> Optional[float]:
    """1 - (union of the device's intervals) / (the slice's wall time), in %."""
    sl = r.get("slice")
    if not sl or not sl["wall_s"] or not sl["device_ops"]:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["wall_s"])


def device_ops_per_step(r: Dict) -> Optional[float]:
    """Device operations in the profiled slice over the control steps it covers."""
    sl = r.get("slice")
    if not sl or not sl["device_ops"]:
        return None
    return sl["device_ops"] / sl["steps"]


def mfu(r: Dict) -> Optional[float]:
    """The networks' FLOPs in the window (forward, plus twice the forward of
    each call whose parameters take gradients) over the window's seconds at
    the float32 peak, in %."""
    if not r.get("flops"):
        return None
    return ys.share_pct(r["flops"], r["window_s"] * ys.F32_FLOPS)
