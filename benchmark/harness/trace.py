"""What the traced run records, all from the benchmark's own side of the
program's calls: spans (CUDA events around a call, or at the trainers'
stage marks), the networks' FLOPs (forward hooks on every dense and
convolution layer), K1's shapes (a wrapper around the name the SoA substep
calls), and one profiled slice of device events, held in memory.

Nothing here runs in an untraced run."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from benchmark.harness import yardstick as ys


class Spans:
    """Named spans of CUDA events: `wrap(obj, attr, name)` replaces a callable
    attribute by one that records an event before and after each call;
    `elapsed_ms(name)` reads them (after a synchronise)."""

    def __init__(self):
        self.events: Dict[str, List] = {}
        self._undo: List = []

    @staticmethod
    def record() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def around(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            before = self.record()
            out = fn(*a, **k)
            self.events.setdefault(name, []).append((before, self.record()))
            return out
        return wrapped

    def wrap(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)
        setattr(obj, attr, self.around(name, orig))
        self._undo.append((obj, attr, orig))

    def restore(self) -> None:
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()

    def elapsed_ms(self, name: str) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]


class StageMarks:
    """A trainer's `timer` hook: a CUDA event at each stage mark; `iterations()`
    gives each iteration's [(stage, event)] list, an iteration opening at
    "start"."""

    def __init__(self):
        self.marks: List = []

    def __call__(self, stage: str) -> None:
        self.marks.append((stage, Spans.record()))

    def iterations(self) -> List[List]:
        its = []
        for stage, ev in self.marks:
            if stage == "start":
                its.append([])
            if its:
                its[-1].append((stage, ev))
        return its


class FlopCounter:
    """Forward hooks on every nn.Linear and nn.Conv1d: the FLOPs of each call,
    split into calls whose parameters take gradients (a backward of twice
    the forward follows) and the rest."""

    def __init__(self):
        self.forward = 0.0
        self.forward_with_grad = 0.0
        self._handle = None

    def _hook(self, module, inputs, output):
        x = inputs[0]
        if isinstance(module, nn.Linear):
            rows = x.numel() // module.in_features
            f = ys.linear_flops(rows, module.in_features, module.out_features)
        elif isinstance(module, nn.Conv1d):
            batch = x.shape[0] if x.dim() == 3 else 1
            f = ys.conv1d_flops(batch, module.in_channels, module.out_channels,
                                module.kernel_size[0], output.shape[-1], module.groups)
        else:
            return
        if torch.is_grad_enabled() and module.weight.requires_grad:
            self.forward_with_grad += f
        else:
            self.forward += f

    def start(self) -> None:
        self._handle = nn.modules.module.register_module_forward_hook(self._hook)

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.remove()
            self._handle = None

    def total(self) -> float:
        return ys.train_flops(self.forward, self.forward_with_grad)


class K1Shapes:
    """The (N, S) of each K1 call: a wrapper around `soa.contact_lcp`, the name
    the SoA substep calls."""

    def __init__(self):
        self.shapes: List = []
        self._orig = None

    def start(self) -> None:
        from agility_tpu_torch.physics import soa

        self._orig = soa.contact_lcp

        def counted(G, *a, **k):
            self.shapes.append((G.shape[0], G.shape[1] // 3))
            return self._orig(G, *a, **k)
        soa.contact_lcp = counted

    def stop(self) -> None:
        if self._orig is not None:
            from agility_tpu_torch.physics import soa

            soa.contact_lcp = self._orig
            self._orig = None


K1_KERNEL = "contact_lcp_kernel"


class Slice:
    """One profiled slice: torch.profiler over host and device, its events
    read in memory (no trace file). `start()` / `stop()` bound it; `stop()`
    synchronises first. Afterwards: `device` [(name, start_s, dur_s)],
    `host` [(name, start_s, dur_s)] of host operators, and `wall_s`, the
    host-clock length of the slice."""

    def __init__(self):
        self.prof = None
        self.device: List = []
        self.host: List = []
        self.wall_s: Optional[float] = None
        self._t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        for e in self.prof.profiler.kineto_results.events():
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            item = (e.name(), e.start_ns() * 1e-9, e.duration_ns() * 1e-9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device.append(item)
            else:
                self.host.append(item)
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def busy_s(self) -> float:
        return ys.union_length((s, s + d) for _, s, d in self.device)

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host operator running at its
        middle ("host" where none was)."""
        agg = ys.aggregate(self.device)
        ops = [[name, secs] for name, secs in agg["s"].most_common(top)]
        idle = sorted(ys.gaps((s, s + d) for _, s, d in self.device),
                      key=lambda g: g[1] - g[0], reverse=True)[:top]
        named = []
        for g0, g1 in idle:
            mid, best = 0.5 * (g0 + g1), None
            for name, s, d in self.host:
                if s <= mid <= s + d and (best is None or d < best[1]):
                    best = (name, d)
            named.append([best[0] if best else "host", g1 - g0])
        return {"device_ops": ops, "idle_gaps": named}

