"""The layer tools' shared timer: interleaved rounds on the synchronised
host clock, then device operations counted.

A step of the port is host-bound (PERF.md §5): the host moves an
iteration's time by up to ±18% within one process, and a profiler session
slows the host's later launches.  So the tools time every variant once per
round, in turn, for several rounds (variant A's round 1, B's round 1, ...,
A's round 2, ...), and report each variant's median with its min and max
over the rounds; and they count device operations (tools/count_ops.ops_of)
only after all timing.

    rows = interleaved([Variant("full", run_full, per=T, ops=one_step), ...], device)
    count_device_ops(rows, variants, device)

A Variant's `run()` is one round's work; `per` is the units (steps) it
covers, so that `ms` is per unit.  If `run()` returns a dict {label: ms}
(readings of its own: the stages a trainer's timer hook read, each for
the whole round), each reading becomes a row of its own after the variant's, with
the same median / min / max.  Each variant also runs once before the
rounds, untimed (its first calls: kernel builds, allocator growth);
`first_s` is that run's seconds.  `launches` is the hand-written kernels'
launches per unit over the timed rounds.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

ROUNDS = 5


@dataclasses.dataclass
class Variant:
    label: str
    run: Callable[[], Any]                  # one round's work
    per: int = 1                            # units a round covers: ms are per unit
    ops: Optional[Callable[[], Any]] = None  # one unit, for the device-op count


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def spread(samples: List[float]) -> dict:
    """ms (median), ms_min, ms_max and the rounds' ms, of per-round ms."""
    return dict(ms=statistics.median(samples), ms_min=min(samples), ms_max=max(samples),
                rounds=list(samples))


def interleaved(variants: List[Variant], device, rounds: int = ROUNDS) -> List[dict]:
    """Every variant run once untimed, then `rounds` rounds of every variant
    once, in the given order, each on the host clock synchronised before
    and after.  Returns a row per variant, in order, each followed by its
    readings' rows: label, ms, ms_min, ms_max, rounds, first_s, launches
    ({kernel: launches per unit}; {} for a reading), ops (None: see
    count_device_ops)."""
    from agility_tpu_torch.kernels import launch_counts

    if rounds < 1:
        raise ValueError(f"interleaved: {rounds} rounds")
    first, host, readings, launches = {}, {}, {}, {}
    for v in variants:
        synchronize(device)
        t0 = time.perf_counter()
        v.run()
        synchronize(device)
        first[v.label] = time.perf_counter() - t0
        host[v.label], readings[v.label] = [], {}
        launches[v.label] = dict.fromkeys(launch_counts(), 0)
    for _ in range(rounds):
        for v in variants:
            before = launch_counts()
            synchronize(device)
            t0 = time.perf_counter()
            got = v.run()
            synchronize(device)
            host[v.label].append((time.perf_counter() - t0) * 1e3 / v.per)
            for k, n in launch_counts().items():
                launches[v.label][k] += n - before[k]
            for label, ms in (got.items() if isinstance(got, dict) else ()):
                readings[v.label].setdefault(label, []).append(ms)
    rows = []
    for v in variants:
        rows.append(dict(label=v.label, **spread(host[v.label]), first_s=first[v.label],
                         launches={k: n / (rounds * v.per) for k, n in launches[v.label].items()},
                         ops=None))
        rows += [dict(label=label, **spread(ms), first_s=None, launches={}, ops=None)
                 for label, ms in readings[v.label].items()]
    return rows


def device_ops(fn: Callable[[], Any], device, reads: int = 1) -> Optional[int]:
    """The device operations fn() issues (tools/count_ops.ops_of), the
    largest of `reads` readings (a reading can drop trace records, never
    add them); None on the CPU (not measured)."""
    from agility_tpu_torch.tools.count_ops import ops_of

    if torch.device(device).type != "cuda":
        return None
    return max(ops_of(fn, device) for _ in range(reads))


def count_device_ops(rows: List[dict], variants: List[Variant], device, reads: int = 1) -> None:
    """Fill `ops` of each variant's row with device_ops(variant.ops): after
    all timing, since a profiler session slows the host's later launches."""
    by_label: Dict[str, dict] = {r["label"]: r for r in rows}
    for v in variants:
        if v.ops is not None:
            by_label[v.label]["ops"] = device_ops(v.ops, device, reads)


def table(rows: List[dict], unit: str = "step") -> str:
    """The rows as aligned text: median ms a unit, [min, max], device ops."""
    return "\n".join(
        f"{r['label']:<40} {r['ms']:10.3f} ms/{unit}  [{r['ms_min']:.3f}, {r['ms_max']:.3f}]  "
        f"{r['ops'] if r['ops'] is not None else 'not measured':>12} device ops" for r in rows)


class StageTimer:
    """A trainer's `timer` hook (SSInfoGAIL, TscPPO and TscVision call it
    with each stage's name once the stage's work is enqueued; "start"
    opens an iteration, the runners add "end"): a CUDA event at each mark
    on the card, the host clock on the CPU; at "start" and "end", also the
    host clock after a synchronise; then `on_mark(stage)`, if given."""

    def __init__(self, device, on_mark=None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.marks = []
        self.host = {"start": [], "end": []}
        self.on_mark = on_mark

    def __call__(self, stage: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((stage, ev))
        if stage in self.host:
            synchronize(self.device)
            self.host[stage].append(time.perf_counter())
        if self.on_mark is not None:
            self.on_mark(stage)

    def iterations(self) -> List[Dict[str, float]]:
        """Each iteration's {stage: ms from the mark before it}, summed over
        a stage's marks (call after a synchronise)."""
        its, prev = [], None
        for stage, ev in self.marks:
            if stage == "start":
                its.append({})
            else:
                ms = prev.elapsed_time(ev) if self.cuda else (ev - prev) * 1e3
                its[-1][stage] = its[-1].get(stage, 0.0) + ms
            prev = ev
        return its

    def wall_ms(self) -> List[float]:
        """Each iteration's host-clock ms from its "start" to its "end"."""
        return [(b - a) * 1e3 for a, b in zip(self.host["start"], self.host["end"])]


def open_device(argv, description: str):
    """A tool's --device (the card unless asked) opened: float32 matmuls
    and convolutions in full float32.  Returns (device, its nvidia-smi
    name and power limit, or "cpu")."""
    from agility_tpu_torch.bench import device_label

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda")
    device = torch.device(p.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device, device_label(device)
