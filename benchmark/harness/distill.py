"""The "distill" traffic kind: the depth student's distillation through the
program's CLI (`cli/train_tsc.build --use_camera`, the configuration's
argv), one `VisionRunner.learn(1)` call at a time, as the CLI runs it.

The build reads its teacher from a temporary `--log_root` in which
`<proj_name>/<resumeid>` links to the repo's teacher directory, so the run
writes nothing into the repo's `logs/`; the writer the build opens is
closed and its directory removed.  Set-up runs one check iteration through
`learn(1)`, recording what the reference follows: every env step's actions
and results, whole env steps at positions drawn from the seed, each
refresh's render inputs and processed image, the four distillation losses,
the teacher's actions, the optimisers' first gradients and the parameters
before and after.  The window then runs whole iterations until the first
one that ends at or after `seconds`.  A traced run turns the program's
tracing on before the build and reads its spans over the window, then
profiles one more iteration from its last camera refresh (render, process,
encode and that chunk's control steps) to the end of BYOL.  The reference
runs after the window, once the program's state is freed."""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict

import torch

from benchmark.harness import common
from benchmark.harness import trace as tr
from benchmark.harness import vision_flops
from benchmark.harness.main import ROOT
from benchmark.reference import core
from benchmark.reference import vision as ref


def learn_once(runner) -> None:
    with common.quiet():
        runner.learn(1)                 # ends with the metrics' fetch to the host


def build(cfg: Dict, seed: int, device: str):
    """The program's student runner, built by its CLI on the teacher the
    configuration names; no log or checkpoint is written."""
    cli = common.cli_module(cfg["train"]["cli"])
    teacher = cfg["train"]["teacher"]
    logs = tempfile.mkdtemp(prefix="agility_bench_distill_")
    link = os.path.join(logs, teacher["link"])
    os.makedirs(os.path.dirname(link))
    os.symlink(os.path.join(ROOT, teacher["dir"]), link)
    argv = list(cfg["train"]["argv"]) + ["--seed", str(seed), "--device", device,
                                         "--log_root", logs]
    try:
        with common.quiet():
            runner = cli.build(cli.get_args(argv))
        if runner.writer is not None:
            runner.writer.close()
        runner.writer, runner.log_dir = None, None
    finally:
        os.unlink(link)                  # the link alone, never the teacher it names
        shutil.rmtree(logs, ignore_errors=True)
    return runner


def record_iteration(runner, traffic: Dict, seed: int) -> Dict:
    """The check iteration through `learn(1)`, with what the reference needs
    recorded (on the host)."""
    env, alg, ts = runner.env, runner.alg, runner.train_state
    T = runner.cfg.num_steps_per_env
    sampled = set(common.sample_positions(seed, 1, traffic["check_env_steps"], (1, T)))
    first_grad: Dict[str, torch.Tensor] = {}
    ref.watch_first_steps(ts, first_grad)
    params0 = ref.snapshot_params(ts)
    rec = dict(start=ref.light_state(runner.env_state), hidden=ts.hidden.clone())
    wrapped = ref.record(env, alg, sampled, rec)
    try:
        learn_once(runner)
    finally:
        for obj, attr in wrapped:
            delattr(obj, attr)
    rec["metrics"] = {k: float(v) for k, v in runner.last_metrics.items()}
    rec["losses"] = {k: float(v) for k, v in rec.get("losses", {}).items()}
    rec["metrics"].update(rec.pop("losses"))
    rec.update(params0=params0, params=ref.snapshot_params(ts), first_grad=first_grad)
    return common.host(rec)


def _stage_sums(marks) -> Dict[str, float]:
    """{stage: ms from the mark before it, summed over the iteration} of one
    iteration's marks (the student's stages repeat every step)."""
    out, prev = {}, None
    for stage, ev in marks:
        if prev is not None:
            out[stage] = out.get(stage, 0.0) + prev.elapsed_time(ev)
        prev = ev
    return out


def _span_sums(records) -> Dict[str, Dict]:
    """{name: {count, ms}} of the program's span records: CUDA-event ms where
    a span has them, else host ms."""
    out: Dict[str, Dict] = {}
    for r in records:
        s = out.setdefault(r.name, dict(count=0, ms=0.0))
        s["count"] += 1
        s["ms"] += r.device_ms if r.device_ms is not None else r.host_ms
    return out


def _counters() -> Dict[str, int]:
    """The student's counters where the program has them (raycast.RENDER,
    depth.BYOL), else nothing."""
    from agility_tpu_torch.learn import depth
    from agility_tpu_torch.render import raycast

    out = {}
    for prefix, c in (("render", getattr(raycast, "RENDER", None)),
                      ("byol", getattr(depth, "BYOL", None))):
        if c is not None:
            out.update({f"{prefix}.{k}": v for k, v in vars(c).items()})
    return out


def window(runner, seconds: float, device: str, traced: bool) -> Dict:
    """Whole iterations until the first that ends at or after `seconds`."""
    from agility_tpu_torch import trace as program_trace
    from agility_tpu_torch.physics import engine

    spans = marks = flops = None
    if traced:
        spans, marks, flops = tr.Spans(), tr.StageMarks(), vision_flops.FlopCounter()
        spans.wrap(engine, "step_batch", "engine")
        runner.alg.timer = marks
        flops.start()
        program_trace.reset()
    counts0 = _counters()
    watch = common.HostWatch(device)
    watch.begin()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ends, t0 = [], time.perf_counter()
    try:
        while True:
            learn_once(runner)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        window_s, iters = ends[-1], len(ends)
    finally:
        if traced:
            flops.stop()
            spans.restore()
            runner.alg.timer = None
    host_watch = watch.end()
    T, N = runner.cfg.num_steps_per_env, runner.env.num_envs
    out = dict(window_s=window_s, iterations=iters, env_steps=iters * T * N,
               iteration_s=[b - a for a, b in zip([0.0] + ends[:-1], ends)],
               memory_peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
               host=host_watch,
               counters={k: v - counts0[k] for k, v in _counters().items()})
    if traced:
        out.update(stages=[_stage_sums(it) for it in marks.iterations()],
                   engine_ms=spans.elapsed_ms("engine"), flops=flops.total(),
                   steps_per_iteration=T, program_spans=_span_sums(program_trace.records()))
    return out


def profiled_slice(runner) -> Dict:
    """One more `learn(1)` with the profiler from the last camera refresh's
    render (its "prep" mark) to the end of BYOL (the "byol" mark)."""
    alg = runner.alg
    T, interval = runner.cfg.num_steps_per_env, runner.env.cfg.depth.update_interval
    refreshes = math.ceil(T / interval)
    sl, seen = tr.Slice(), [0]

    def timer(stage):
        if stage == "prep":
            seen[0] += 1
            if seen[0] == refreshes:
                sl.start()
        elif stage == "byol" and sl.active:
            sl.stop()

    alg.timer = timer
    try:
        learn_once(runner)
    finally:
        alg.timer = None
    return common.slice_readings(sl, T - (refreshes - 1) * interval, [])


def judge(cfg: Dict, rec: Dict, seed: int, device: str, control: bool = False) -> Dict:
    """The reference through the recorded iteration, its images and env
    steps: the numbers compared, and with `control`, the control's and the
    faults' readings of the same numbers."""
    core.tf32(False)
    env = ref.make_env(dict(cfg["reference"]["overrides"], seed=seed), device, seed)
    rep = ref.make_trainer(env, seed, cfg)
    out = rep.iteration(rec)
    images = ref.render_reference(rep, rec["renders"])
    full = [common.to_device(f, device) for f in rec["full"]]
    env_gaps = [ref.env_gap(env, f) for f in full]
    prog = dict(metrics=rec["metrics"],
                actions=dict(hl_actions=torch.stack([s["hl_actions"] for s in rec["steps"]]),
                             bbc_actions=torch.stack([s["bbc_actions"] for s in rec["steps"]]),
                             teacher_actions=rec["teacher_actions"]),
                first_grad=rec["first_grad"], params0=rec["params0"], params=rec["params"])
    img = ref.image_numbers([r["image"] for r in rec["renders"]], images)
    numbers = _numbers(prog, out, rep, env_gaps, img, device)
    result = dict(numbers=numbers, env_gaps=env_gaps, depth_left_out=img["depth_left_out"])
    if control:
        result["control"] = _control(cfg, env, rec, full, out, rep, images, seed, device)
    return result


def _as_program(rep, out) -> Dict:
    return dict(metrics=out["metrics"], actions={k: out[k] for k in ref.ACTION_KEYS},
                first_grad=rep.first_grad, params0=rep.params0,
                params=ref.snapshot_params(rep.ts))


def _control(cfg, env, rec, full, out, rep, images, seed, device) -> Dict:
    """The control, the reference with TF32 in the program's place, and the
    faults read through the same numbers: an update that leaves the
    parameters unchanged, an env step that returns its state unchanged, and
    an env step's answer and a refresh image altered where they are
    produced, in every env and in one."""
    old = core.tf32(True)
    try:
        rep_c = ref.make_trainer(env, seed, cfg)
        out_c = rep_c.iteration(rec)
    finally:
        core.tf32(old)
    images_c = ref.render_reference(rep, rec["renders"], with_tf32=True)
    gaps_c = [ref.control_env_gap(env, f) for f in full]
    img_c = ref.image_numbers([i for i, _ in images_c], images)
    tf32 = _numbers(_as_program(rep_c, out_c), out, rep, gaps_c, img_c, device)
    del rep_c, out_c, images_c
    faults = [ref.fault_gaps(env, f) for f in full]
    read = {k: core.env_numbers([g[k] for g in faults]) for k in faults[0]}
    imgs = ref.image_faults(images)
    return dict(tf32=tf32, unchanged=dict(read["unchanged"], change_gap=1.0),
                altered=dict(read["altered"], **imgs["altered"]),
                one_env=dict(read["one_env"], **imgs["one_env"]))


def _numbers(prog: Dict, out: Dict, rep, env_gaps, img: Dict, device) -> Dict[str, float]:
    """The numbers compared: the widest env-step gap and the outlying envs,
    the refresh images' gap and outlying envs over the kept pixels, the
    widest action gap and loss gap, the worst leaf's first-gradient gap and
    parameter-change gap."""
    params = ref.snapshot_params(rep.ts)
    loss = core.loss_gap(prog["metrics"], out["metrics"], ref.LOSS_KEYS) \
        if all(k in prog["metrics"] for k in ref.LOSS_KEYS) else math.inf
    action = max(core.rel_gap(prog["actions"][k].to(device), out[k].to(device))
                 for k in ref.ACTION_KEYS)
    grad = core.leaf_norm_gap(common.to_device(prog["first_grad"], device), rep.first_grad)
    keep = [k for k in core.moving_leaves(rep.first_grad) if k in params]
    d_prog = {k: prog["params"][k].to(device) - prog["params0"][k].to(device) for k in keep}
    d_ref = {k: params[k] - rep.params0[k] for k in keep}
    change = core.leaf_norm_gap(d_prog, d_ref)
    return dict(core.env_numbers(env_gaps), depth_gap=img["depth_gap"],
                depth_outliers=img["depth_outliers"], action_gap=action, loss_gap=loss,
                grad_gap=grad["gap"], change_gap=change["gap"])


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
        control: bool = False, fault=None) -> Dict:
    """One run: set-up, the window, (traced) the profiled slice, then the
    reference.  `fault`, for the harness's own tests, breaks the program
    after set-up's build (a callable taking the runner)."""
    from agility_tpu_torch import trace as program_trace

    t0 = time.perf_counter()
    if traced:
        program_trace.enable(device)
    try:
        runner = build(cfg, seed, device)
        if fault is not None:
            fault(runner)
        rec = record_iteration(runner, traffic, seed)
        common.sync(device)
        setup_s = time.perf_counter() - t0
        win = window(runner, seconds, device, traced)
        readings = dict(win)
        if traced and device == "cuda":
            readings["slice"] = profiled_slice(runner)
    finally:
        program_trace.disable()
        program_trace.reset()
    del runner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judged = judge(cfg, rec, seed, device, control)
    judged["seconds"] = time.perf_counter() - t_judge
    _log(win, judged)
    e2e = dict(setup_s=setup_s, train_env_steps_per_s=win["env_steps"] / win["window_s"])
    return dict(end_to_end=e2e, readings=readings, memory_peak=win["memory_peak"],
                attempted=win["iterations"], numbers=judged["numbers"], judged=judged)


def _log(win: Dict, judged: Dict) -> None:
    """What a reader of the log wants of this kind beside main's DETAIL line:
    the student's counters over the window, the pixels the crossing rule
    left out, the peak memory, and (traced) the mean ms of each stage and of
    each of the program's spans an iteration."""
    stages, iters = win.get("stages") or [], win["iterations"]
    names = sorted({k for st in stages for k in st})
    print("DISTILL " + json.dumps(dict(
        counters=win["counters"], depth_left_out=judged["depth_left_out"],
        memory_peak=win["memory_peak"],
        stage_ms={k: sum(st.get(k, 0.0) for st in stages) / len(stages) for k in names},
        span_ms={k: v["ms"] / iters for k, v in (win.get("program_spans") or {}).items()})),
        file=sys.stderr)
