"""Named spans over the port's layers, from the CLIs' build and the trainers'
stages down to the SoA substep.

Off by default, and then it costs a flag test: `span(name)` returns one
shared no-op object and `spanned(name)` calls the function it wraps
directly; no CUDA event is recorded, no profiler annotation entered, no
device synchronised.  `enable(device)` turns it on (the CLIs' --trace).
Each span then keeps its name, its parent (the span open around it), its
host start and end (`time.perf_counter_ns`) and, on CUDA, a pair of
`torch.cuda.Event`s read only when the records are (`records`, `summary`
synchronise first, never a span); and it enters
`torch.profiler.record_function(name)`, so a profiler running at the time
holds the span on the profiler's own clock, beside the device's events.

The trainers' stage marks are span boundaries too (`mark`): a mark closes
the span open since the previous mark, named `train.<stage>` after the
stage it closes, and opens the next.  Since a stage's name is known only at
its end, its profiler annotation is entered as `train.stage`.

Names give the layer: build.*, train.<stage>, rollout.*, policy, env.*,
engine.* (README.md, "Tracing", lists them with their parents).
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

ON = False
_STAGE = "train.stage"           # a trainer stage's profiler annotation

_cuda = False
_records: List["_Span"] = []
_stack: List["_Span"] = []      # the `with` spans open, innermost last
_stage: Optional["_Span"] = None  # the trainer stage open since the last mark


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    host_ms: float
    device_ms: Optional[float]   # between the span's CUDA events; None off CUDA


class _Off:
    """The shared no-op span of tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "sync", "t0", "t1", "ev0", "ev1", "rf")

    def __init__(self, name: str, sync: bool = False):
        self.name, self.sync = name, sync

    def open(self, annotation: str) -> "_Span":
        self.parent = _stack[-1] if _stack else _stage
        self.rf = torch.profiler.record_function(annotation)
        self.rf.__enter__()
        self.ev0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def close(self) -> None:
        if self.sync and _cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.ev1 = _event()
        self.rf.__exit__(None, None, None)
        _records.append(self)

    def __enter__(self):
        self.open(self.name)
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack.pop()
        self.close()
        return False


def _event() -> Optional[torch.cuda.Event]:
    if not _cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def enable(device="cuda") -> None:
    """Turn tracing on; on a CUDA `device` (where torch sees one) spans also
    record CUDA events."""
    global ON, _cuda
    ON = True
    _cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()


def disable() -> None:
    """Turn tracing off; an open trainer stage is dropped, the records kept."""
    global ON, _stage
    ON = False
    if _stage is not None:
        _stage.rf.__exit__(None, None, None)
        _stage = None


def reset() -> None:
    """Forget the closed spans (spans still open are recorded when they close)."""
    _records.clear()


def span(name: str, sync: bool = False):
    """A context manager over a layer's work: with tracing off the shared
    no-op; with it on, a span.  `sync` synchronises the device before the
    span's host clock stops (for a span whose host time is the reading)."""
    return _Span(name, sync) if ON else _OFF


def spanned(name: str) -> Callable:
    """A decorator: each call of the function is a span `name` (a direct call
    with tracing off)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def mark(timer: Optional[Callable[[str], None]], stage: str) -> None:
    """A trainer's stage mark, once the stage's work is enqueued: `timer` (the
    trainer's hook, or None) is handed the stage's name.  With tracing on
    the span open since the previous mark closes as `train.<stage>` (at
    "start", which opens an iteration, it is dropped: it covered no stage),
    and unless the stage is the runner's "end" the next one opens."""
    global _stage
    if ON and _stage is not None:
        if stage == "start":
            _stage.rf.__exit__(None, None, None)
        else:
            _stage.name = "train." + stage
            _stage.close()
        _stage = None
    if timer is not None:
        timer(stage)
    if ON and stage != "end":
        _stage = _Span(_STAGE).open(_STAGE)


def records() -> List[Record]:
    """The closed spans in the order they closed, each with its parent's
    name and its host and device ms (synchronises a CUDA device first)."""
    timed = [r.ev0 is not None and r.ev1 is not None for r in _records]
    if any(timed):
        torch.cuda.synchronize()
    return [Record(r.name, r.parent.name if r.parent is not None else None,
                   (r.t1 - r.t0) * 1e-6, r.ev0.elapsed_time(r.ev1) if t else None)
            for r, t in zip(_records, timed)]


def summary() -> Dict[str, Dict]:
    """{name: {count, host_ms, device_ms, parent}} over the closed spans: the
    ms summed (device_ms None off CUDA), the parent that of the first."""
    out: Dict[str, Dict] = {}
    for r in records():
        s = out.setdefault(r.name, dict(count=0, host_ms=0.0, device_ms=None, parent=r.parent))
        s["count"] += 1
        s["host_ms"] += r.host_ms
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return out


def per_unit_ms(units: int) -> Dict[str, float]:
    """Each span's ms over `units` (iterations, control steps): its CUDA-event
    time where it has one, else its host time."""
    return {name: (s["device_ms"] if s["device_ms"] is not None else s["host_ms"]) / units
            for name, s in summary().items()}
