"""Where a control step's time and the device's idle go, read through the
program's own spans (agility_tpu_torch/trace.py), at the benchmark cells'
shapes:

    python -m agility_tpu_torch.tools.span_slice --run bbc_train   # one CUDA card
    python -m agility_tpu_torch.tools.span_slice --run tsc_train
    python -m agility_tpu_torch.tools.span_slice --run bbc_play
    python -m agility_tpu_torch.tools.span_slice --run bbc_train --device cpu \\
        --task go2_locomotion_smoke --num_envs 8                  # a tiny CPU rehearsal

A run builds the program through its CLI with --trace (bbc_train and
tsc_train: `learn(1)` calls, as `cli/train_*.build` builds the runner;
bbc_play: `play_bbc.build`, trot at 1.0 m/s with bbc_final), warms up, then:

  1. rounds with tracing off and on in turn (train: one iteration a round;
     play: `--play_steps` control steps), each on the host clock
     synchronised at both ends: the on-cost;
  2. from the on rounds, each span's calls, CUDA-event ms and host ms a
     control step, beside an outside CUDA-event wrapper around
     `engine.step_batch` (the one the benchmark puts there) and the sum of
     the engine's parts;
  3. one profiled slice with tracing on (train: the last `--slice_steps`
     env steps of one more iteration; play: that many steps): device ops a
     step, busy and idle, the idle gaps put down to the innermost span
     open on the host over each (`idle_by_span`), and the host µs per
     device op launched inside each `engine` span (`issue_us_per_op`);
     then the ops of one more slice with tracing off;
  4. the host µs of one empty span, on and off;
  5. how often the SoA substep's two CUDA graphs were captured and replayed
     over the whole run (soa.FREE_DYNAMICS, soa.CONTACT_APPLY: one capture
     each, one replay a substep), and the free-dynamics kernel's calls
     (kernels/free_dynamics.py: two a capture of the first graph, its
     warm-up and the capture; none a replay).

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from agility_tpu_torch import trace
from agility_tpu_torch.kernels.free_dynamics import free_dynamics
from agility_tpu_torch.physics import soa

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
PLAY_CHECKPOINT = os.path.join(ROOT, "logs", "bbc_r5", "bbc_final.msgpack")
TSC_FLAGS = ["--randomize_start", "--randomize_base_mass", "--randomize_base_com",
             "--push_robots"]
# the benchmark cells' programs: (CLI, its arguments, learn()'s keywords)
RUNS = {
    "bbc_train": ("train_bbc", ["--task", "go2_locomotion", "--num_envs", "4096"],
                  dict(init_at_random_ep_len=False)),
    "tsc_train": ("train_tsc", ["--task", "go2", "--num_envs", "6144", "--courses", "64",
                                "--bbc_path", PLAY_CHECKPOINT] + TSC_FLAGS, {}),
    "bbc_play": ("play_bbc", ["--task", "go2_locomotion", "--num_envs", "4096", "--checkpoint",
                              PLAY_CHECKPOINT, "--mode", "trot", "--vx", "1.0"], None),
}
NONE = "(no span)"


# ---------------------------------------------------------------------------
# arithmetic on a slice's intervals (seconds), tested on the CPU
# ---------------------------------------------------------------------------


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint pieces, in time order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The stretches between the union's pieces (the device's idle gaps)."""
    pieces = union(intervals)
    return [(a[1], b[0]) for a, b in zip(pieces, pieces[1:])]


def innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The time line cut where a span opens or closes, each piece named by
    the innermost span open over it (the latest opened; spans nest), or
    NONE."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, -e, n) for s, e, n in spans if s <= a and b <= e]
        out.append((a, b, max(open_)[2] if open_ else NONE))
    return out


def idle_by_span(device: Iterable[Tuple[float, float]],
                 spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """{span name: seconds of device idle inside it}: each idle gap between
    the device's intervals put down, piece by piece, to the innermost span
    open over it on the host (NONE where none is)."""
    out: Dict[str, float] = {}
    pieces = innermost(spans)
    i = 0
    for g0, g1 in gaps(device):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            j += 1
        if g1 - g0 - covered > 0:
            out[NONE] = out.get(NONE, 0.0) + (g1 - g0 - covered)
    return out


def by_innermost(spans: Sequence[Tuple[float, float, str]],
                 times: Iterable[float]) -> Tuple[Dict[str, float], Dict[str, int]]:
    """({span: seconds in which it is the innermost open}, {span: how many of
    `times` fall where it is the innermost}): a span's own time and, with
    the device ops' launch times, the ops it issues itself."""
    import bisect

    pieces = innermost(spans)
    own: Dict[str, float] = {}
    for a, b, name in pieces:
        own[name] = own.get(name, 0.0) + (b - a)
    starts, count = [a for a, _, _ in pieces], {}
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        name = pieces[i][2] if i >= 0 and t <= pieces[i][1] else NONE
        count[name] = count.get(name, 0) + 1
    return own, count


def ops_inside(spans: Sequence[Tuple[float, float, str]], name: str, ops: Sequence[int],
               launches: Dict[int, float]) -> int:
    """The device ops launched inside a span called `name`: each device op
    (its correlation id in `ops`) is matched to its runtime launch by that
    id (`launches`: id -> the launch's host start), and counts if the
    launch starts within one of those spans."""
    mine = [(s, e) for s, e, n in spans if n == name]
    return sum(any(s <= launches[c] <= e for s, e in mine) for c in ops if c in launches)


def issue_us_per_op(spans: Sequence[Tuple[float, float, str]], name: str,
                    ops: Sequence[int], launches: Dict[int, float]) -> Optional[float]:
    """Host µs of the spans called `name` over the device ops launched inside
    them (`ops_inside`); None where there is no such span or op."""
    count = ops_inside(spans, name, ops, launches)
    host = sum(e - s for s, e, n in spans if n == name)
    return 1e6 * host / count if count else None


def per_step(records: Sequence[trace.Record], steps: int) -> Dict[str, Dict]:
    """{name: calls, device ms, host ms a control step, parent} of records."""
    out: Dict[str, Dict] = {}
    for r in records:
        s = out.setdefault(r.name, dict(calls=0, device_ms=0.0, host_ms=0.0, parent=r.parent))
        s["calls"] += 1
        s["device_ms"] += r.device_ms if r.device_ms is not None else r.host_ms
        s["host_ms"] += r.host_ms
    for s in out.values():
        for k in ("calls", "device_ms", "host_ms"):
            s[k] /= steps
    return out


def self_ms(records: Sequence[trace.Record], name: str, child: str,
            steps: int) -> Optional[float]:
    """ms a step of the spans called `name` less that of their `child` spans
    (None without a span called `name`)."""
    ms = lambda r: r.device_ms if r.device_ms is not None else r.host_ms
    if not any(r.name == name for r in records):
        return None
    return (sum(ms(r) for r in records if r.name == name)
            - sum(ms(r) for r in records if r.name == child and r.parent == name)) / steps


# ---------------------------------------------------------------------------
# the profiled slice
# ---------------------------------------------------------------------------


class Slice:
    """torch.profiler over host and device from start() to stop() (which
    synchronises first), its events read in memory."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        _sync(self.cuda)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        _sync(self.cuda)
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        events = list(self.prof.profiler.kineto_results.events())
        cuda = torch.autograd.DeviceType.CUDA
        # a span's annotation may be copied onto the device's time line under
        # its name (kineto's gpu_user_annotation): counted apart, not an op
        names = {e.name() for e in events if e.is_user_annotation() and e.device_type() != cuda}
        device, ops, spans, launches = [], [], [], {}
        annotations = dict(flagged=0, by_name=0)     # is_user_annotation() says so, or not
        for e in events:
            t0, t1 = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if e.device_type() == cuda:
                if e.is_user_annotation() or e.name() in names:
                    annotations["flagged" if e.is_user_annotation() else "by_name"] += 1
                else:
                    device.append((t0, t1))
                    ops.append(e.correlation_id())
            elif e.is_user_annotation():
                spans.append((t0, t1, e.name()))
            elif e.name().startswith("cu"):
                launches[e.correlation_id()] = t0
        self.prof = None
        busy = sum(b - a for a, b in union(device))
        return dict(wall_s=wall, busy_s=busy, device=device, ops=ops, spans=spans,
                    launches=launches, gpu_annotations=annotations)


def read_slice(raw: Dict, steps: int) -> Dict:
    """A slice's readings: ops a step, busy, idle, idle_by_span,
    issue_us_per_op and the ops launched inside `engine` a step."""
    idle = raw["wall_s"] - raw["busy_s"]
    by_span = idle_by_span(raw["device"], raw["spans"])
    named = sum(v for k, v in by_span.items() if k != NONE)
    return dict(steps=steps, wall_s=raw["wall_s"], busy_s=raw["busy_s"],
                idle_share=idle / raw["wall_s"], device_ops_per_step=len(raw["ops"]) / steps,
                gpu_annotations=raw["gpu_annotations"],
                idle_s=idle, gaps_s=sum(b - a for a, b in gaps(raw["device"])),
                idle_by_span_s=dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
                idle_in_named_spans=named / idle if idle > 0 else None,
                ops_matched_to_launch=(sum(c in raw["launches"] for c in raw["ops"])
                                       / len(raw["ops"]) if raw["ops"] else None),
                issue_us_per_op=issue_us_per_op(raw["spans"], "engine", raw["ops"],
                                                raw["launches"]),
                engine_ops_per_step=ops_inside(raw["spans"], "engine", raw["ops"],
                                               raw["launches"]) / steps,
                own_by_span=_own(raw, steps))


def _own(raw: Dict, steps: int) -> Dict[str, Dict]:
    """{span: its own host ms a step, the device ops it launches itself a
    step, and the host µs a launched op} in the slice (the profiler's host:
    slower than unprofiled)."""
    own, ops = by_innermost(raw["spans"], [raw["launches"][c] for c in raw["ops"]
                                           if c in raw["launches"]])
    return {name: dict(ms=1e3 * sec / steps, ops=ops.get(name, 0) / steps,
                       us_per_op=1e6 * sec / ops[name] if ops.get(name) else None)
            for name, sec in sorted(own.items(), key=lambda kv: -kv[1])}


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


class Outside:
    """CUDA events (host clock on the CPU) around every call of
    `engine.step_batch`, by attribute, as the benchmark's wrapper."""

    def __init__(self, cuda: bool):
        from agility_tpu_torch.physics import engine

        self.cuda, self.engine, self.pairs = cuda, engine, []
        self.orig = engine.step_batch

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        def wrapped(*a, **k):
            before = self._stamp()
            out = self.orig(*a, **k)
            self.pairs.append((before, self._stamp()))
            return out
        self.engine.step_batch = wrapped
        return self

    def __exit__(self, *exc):
        self.engine.step_batch = self.orig
        return False

    def ms(self) -> List[float]:
        _sync(self.cuda)
        return [a.elapsed_time(b) if self.cuda else (b - a) * 1e3 for a, b in self.pairs]


def span_us(cuda: bool, n: int = 20000) -> Dict[str, float]:
    """Host µs of one empty `with trace.span(...)`, tracing off and on."""
    out = {}
    was = trace.ON
    for label, on in (("off", False), ("on", True)):
        if on:
            trace.enable("cuda" if cuda else "cpu")
        else:
            trace.disable()
        _sync(cuda)
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("span_slice.empty"):
                pass
        _sync(cuda)
        out[label] = 1e6 * (time.perf_counter() - t) / n
    trace.reset()
    if not was:
        trace.disable()
    return out


def _rounds(run_one, rounds: int, cuda: bool, outside: Outside) -> Tuple[Dict, List]:
    """`rounds` pairs of rounds, off then on (alternating which leads):
    each round's host seconds, and the on rounds' records."""
    secs: Dict[str, List[float]] = {"off": [], "on": []}
    recs: List[trace.Record] = []
    for i in range(rounds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                trace.enable("cuda" if cuda else "cpu")
                trace.reset()
            else:
                trace.disable()
            _sync(cuda)
            t = time.perf_counter()
            if on:
                with outside:
                    run_one()
            else:
                run_one()
            _sync(cuda)
            secs["on" if on else "off"].append(time.perf_counter() - t)
            if on:
                recs += trace.records()
                trace.disable()
                trace.reset()
    return secs, recs


def run_train(cli, argv, learn_kw, device, rounds: int, slice_steps: int) -> Dict:
    cuda = torch.device(device).type == "cuda"
    logs = tempfile.mkdtemp(prefix="span_slice_")
    try:
        runner = cli.build(cli.get_args(argv + ["--device", device, "--log_root", logs,
                                                "--trace"]))
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    build = {r.name: r.host_ms for r in trace.records() if r.name.startswith("build")}
    if runner.writer is not None:
        runner.writer.close()
    runner.writer, runner.log_dir = None, None
    learn = lambda: runner.learn(1, **learn_kw)
    trace.disable()
    trace.reset()
    learn()                                               # warm: every shape once
    T = runner.cfg.num_steps_per_env
    outside = Outside(cuda)
    secs, recs = _rounds(learn, rounds, cuda, outside)
    steps = rounds * T
    out = dict(build_ms=build, iteration_s=secs, **_spans(recs, steps, outside.ms()))
    print("rounds " + json.dumps(out), file=sys.stderr, flush=True)

    env = runner.env
    for on in (True, False):
        sl, count, got = Slice(device), [0], {}

        def step(state, actions, sl=sl, count=count, got=got):
            new = type(env).step(env, state, actions)
            count[0] += 1
            if count[0] == T - slice_steps:
                sl.start()
            elif count[0] == T:
                got["raw"] = sl.stop()
            return new

        if on:
            trace.enable(device)
        env.step = step
        try:
            learn()
        finally:
            del env.step
            trace.disable()
            trace.reset()
        read = read_slice(got["raw"], slice_steps)
        if on:
            out["slice"] = read
        else:
            out["slice_off"] = {k: read[k] for k in ("device_ops_per_step", "idle_share",
                                                     "wall_s", "busy_s")}
    return out


def run_play(argv, device, rounds: int, play_steps: int, slice_steps: int) -> Dict:
    from agility_tpu_torch.cli import play_bbc

    cuda = torch.device(device).type == "cuda"
    env, policy, _, hold = play_bbc.build(play_bbc.get_args(argv + ["--device", device,
                                                                    "--trace"]))
    build = {r.name: r.host_ms for r in trace.records() if r.name.startswith("build")}
    trace.disable()
    trace.reset()
    state = [env.init_state()]

    def play(n):
        for _ in range(n):
            s = hold(state[0])
            state[0], _ = env.step(s, policy(s.obs_buf))

    play(3)                                               # warm
    outside = Outside(cuda)
    secs, recs = _rounds(lambda: play(play_steps), rounds, cuda, outside)
    out = dict(build_ms=build, round_s=secs,
               **_spans(recs, rounds * play_steps, outside.ms()))
    print("rounds " + json.dumps(out), file=sys.stderr, flush=True)
    for on in (True, False):
        if on:
            trace.enable(device)
        sl = Slice(device)
        sl.start()
        play(slice_steps)
        read = read_slice(sl.stop(), slice_steps)
        trace.disable()
        trace.reset()
        if on:
            out["slice"] = read
        else:
            out["slice_off"] = {k: read[k] for k in ("device_ops_per_step", "idle_share",
                                                     "wall_s", "busy_s")}
    return out


def _spans(recs, steps: int, outside_ms: List[float]) -> Dict:
    """The on rounds' span readings a control step, the engine against the
    outside wrapper and against the sum of its parts."""
    spans = per_step(recs, steps)
    eng = spans.get("engine", {}).get("device_ms")
    parts = sum(spans.get(n, {}).get("device_ms", 0.0) for n in (
        "engine.terrain_window", "engine.free_dynamics", "engine.contact", "engine.integrate"))
    outside = statistics.mean(outside_ms) if outside_ms else None
    return dict(steps=steps, spans=spans, engine_ms=eng, engine_outside_ms=outside,
                engine_vs_outside=eng / outside if eng and outside else None,
                engine_parts_ms=parts, parts_vs_engine=parts / eng if eng else None,
                env_self_ms=self_ms(recs, "env.step", "engine", steps))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", choices=sorted(RUNS), required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--task", default=None, help="replaces the run's task (a CPU rehearsal)")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rounds", type=int, default=2, help="pairs of off and on rounds")
    p.add_argument("--play_steps", type=int, default=10, help="control steps a play round")
    p.add_argument("--slice_steps", type=int, default=2)
    a = p.parse_args(argv)
    from agility_tpu_torch.bench import device_label
    from agility_tpu_torch.tools.timing import open_device

    device, label = open_device(["--device", a.device], __doc__.splitlines()[0])
    name, run_argv, learn_kw = RUNS[a.run]
    run_argv = list(run_argv)
    for flag, v in (("--task", a.task), ("--num_envs", a.num_envs)):
        if v is not None:
            run_argv[run_argv.index(flag) + 1] = str(v)
    dev = str(device)
    if name == "play_bbc":
        out = run_play(run_argv, dev, a.rounds, a.play_steps, a.slice_steps)
    else:
        import importlib

        cli = importlib.import_module(f"agility_tpu_torch.cli.{name}")
        out = run_train(cli, run_argv + ["--seed", str(a.seed)], learn_kw, dev, a.rounds,
                        a.slice_steps)
    cuda = device.type == "cuda"
    counts = lambda g: dict(captures=g.captures, replays=g.replays)
    res = dict(run=a.run, device=label if cuda else device_label(device),
               torch=torch.__version__, argv=run_argv, span_us=span_us(cuda),
               free_dynamics_graph=counts(soa.FREE_DYNAMICS),
               free_dynamics_launches=free_dynamics.launches,
               contact_apply_graph=counts(soa.CONTACT_APPLY), **out)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
