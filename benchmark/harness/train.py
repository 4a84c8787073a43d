"""The "train" traffic kind: training through the program's CLI (the
configuration names it: `cli/train_bbc.build` for the BBC's SSInfoGAIL,
`cli/train_tsc.build` for the TSC teacher's PPO), one `learn(1)` call of the
runner at a time, as the CLI runs it.

Set-up builds the runner from the seed and runs the traffic's check
iterations through that same call, recording what the reference follows:
each env step's outputs, a few whole env steps drawn from the seed, each
iteration's losses, the optimisers' first gradients, and the parameters
before and after.  The window then runs whole iterations until the first
one that ends at or after `seconds`.  The reference runs after the window,
once the program's state is freed."""
from __future__ import annotations

import gc
import importlib
import os
import shutil
import tempfile
import time
from typing import Dict

import torch

from benchmark.harness import common
from benchmark.harness import trace as tr
from benchmark.reference import core


def family(cfg: Dict):
    """The reference module of the configuration's trainer:
    benchmark/reference/<family>.py."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']['family']}")


def learn_once(runner, cfg: Dict) -> None:
    with common.quiet():
        runner.learn(1, **cfg["train"].get("learn_kwargs", {}))   # ends with a synchronise


def _metrics_to_host(metrics: Dict) -> Dict[str, float]:
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def build(cfg: Dict, seed: int, device: str):
    """The program's runner, built by its CLI; the log directory its build
    opens is closed and removed, so the run writes no log and no checkpoint."""
    cli = common.cli_module(cfg["train"]["cli"])
    logs = os.path.join(tempfile.gettempdir(), "agility_bench_logs")
    argv = list(cfg["train"]["argv"]) + ["--seed", str(seed), "--device", device,
                                         "--log_root", logs]
    with common.quiet():
        runner = cli.build(cli.get_args(argv))
    if runner.writer is not None:
        runner.writer.close()
    runner.writer, runner.log_dir = None, None
    shutil.rmtree(logs, ignore_errors=True)
    return runner


def record_iterations(runner, cfg: Dict, traffic: Dict, seed: int) -> Dict:
    """The check iterations, through `learn(1)`, with what the reference needs
    recorded (on the host)."""
    ref = family(cfg)
    env, ts = runner.env, runner.train_state
    K, T = traffic["check_iterations"], runner.cfg.num_steps_per_env
    sampled = set(common.sample_positions(seed, 1, traffic["check_env_steps"], (K, T)))
    first_grad: Dict[str, torch.Tensor] = {}
    ref.watch_first_steps(ts, first_grad)
    params0 = ref.snapshot_params(ts)
    iterations, full = [], []
    for it in range(K):
        steps = []
        start, disc_hist = ref.light_state(runner.env_state), runner.disc_hist.clone()
        wrapped = ref.record(env, sampled, it, steps, full)
        try:
            learn_once(runner, cfg)
        finally:
            for attr in wrapped:
                delattr(env, attr)
        iterations.append(common.host(dict(start=start, disc_hist=disc_hist, steps=steps,
                                           metrics=_metrics_to_host(runner.last_metrics))))
    return dict(iterations=iterations, full=full, params0=common.host(params0),
                params=common.host(ref.snapshot_params(ts)),
                first_grad=common.host(first_grad))


def window(runner, cfg: Dict, seconds: float, device: str, traced: bool) -> Dict:
    """Whole iterations until the first that ends at or after `seconds`."""
    from agility_tpu_torch.physics import engine

    spans = marks = flops = k1 = None
    if traced:
        spans, marks, flops, k1 = tr.Spans(), tr.StageMarks(), tr.FlopCounter(), tr.K1Shapes()
        spans.wrap(engine, "step_batch", "engine")
        runner.alg.timer = marks
        flops.start()
        k1.start()
    watch = common.HostWatch(device)
    watch.begin()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ends, t0 = [], time.perf_counter()
    try:
        while True:
            learn_once(runner, cfg)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        window_s, iters = ends[-1], len(ends)
    finally:
        if traced:
            flops.stop()
            k1.stop()
            spans.restore()
            runner.alg.timer = None
    host_watch = watch.end()
    T, N = runner.cfg.num_steps_per_env, runner.env.num_envs_global
    out = dict(window_s=window_s, iterations=iters, env_steps=iters * T * N,
               iteration_s=[b - a for a, b in zip([0.0] + ends[:-1], ends)],
               memory_peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
               host=host_watch)
    if traced:
        out.update(stages=[_stage_ms(it) for it in marks.iterations()],
                   engine_ms=spans.elapsed_ms("engine"), flops=flops.total(),
                   steps_per_iteration=T, k1_shapes=k1.shapes)
    return out


def _stage_ms(marks) -> Dict[str, float]:
    """{stage: ms from the mark before it} of one iteration's marks."""
    out, prev = {}, None
    for stage, ev in marks:
        if prev is not None:
            out[stage] = prev.elapsed_time(ev)
        prev = ev
    out["_order"] = [s for s, _ in marks]
    return out


def profiled_slice(runner, cfg: Dict, steps: int, k1_shapes) -> Dict:
    """One more `learn(1)` with the profiler over its last `steps` control
    steps, from the end of the env step before them to the end of the last."""
    env = runner.env
    T = runner.cfg.num_steps_per_env
    sl, count = tr.Slice(), [0]

    def step(state, actions):
        new = type(env).step(env, state, actions)
        count[0] += 1
        if count[0] == T - steps:
            sl.start()
        elif count[0] == T and sl.active:
            sl.stop()
        return new

    env.step = step
    try:
        learn_once(runner, cfg)
    finally:
        del env.step
    return common.slice_readings(sl, steps, k1_shapes)


def _replay(ref, env, rec, seed, device, cfg):
    rep = ref.make_trainer(env, seed, cfg)
    outs = [rep.iteration(it, common.to_device(r, device))
            for it, r in enumerate(rec["iterations"])]
    return rep, outs


def judge(cfg: Dict, rec: Dict, seed: int, device: str, control: bool = False) -> Dict:
    """The reference through the recorded iterations and env steps: the
    numbers compared, and with `control`, the control's and the faults'
    readings of the same numbers."""
    ref = family(cfg)
    core.tf32(False)
    env = ref.make_env(dict(cfg["reference"]["overrides"], seed=seed), device, seed)
    rep, outs = _replay(ref, env, rec, seed, device, cfg)
    params = ref.snapshot_params(rep.ts)
    full = [common.to_device(f, device) for f in rec["full"]]
    env_gaps = [ref.env_gap(env, f) for f in full]
    prog = dict(metrics=[r["metrics"] for r in rec["iterations"]],
                actions={k: [torch.stack([s[k] for s in r["steps"]]) for r in rec["iterations"]]
                         for k in ref.ACTION_KEYS},
                first_grad=common.to_device(rec["first_grad"], device),
                params0=common.to_device(rec["params0"], device),
                params=common.to_device(rec["params"], device))
    numbers = _numbers(ref, prog, outs, rep, params, env_gaps, device)
    result = dict(numbers=numbers, env_gaps=env_gaps)
    if control:
        result["control"] = _control(ref, cfg, env, rec, full, outs, rep, params, seed, device)
    return result


def _as_program(ref, rep, outs) -> Dict:
    return dict(metrics=[o["metrics"] for o in outs],
                actions={k: [o[k] for o in outs] for k in ref.ACTION_KEYS},
                first_grad=rep.first_grad, params0=rep.params0,
                params=ref.snapshot_params(rep.ts))


def _control(ref, cfg, env, rec, full, outs, rep, params, seed, device) -> Dict:
    """The control, the reference with TF32 in the program's place, and the
    faults read through the same numbers: the reference's replay with half
    of each minibatch left out, an env step that returns its state unchanged,
    and an env step whose answer is altered where it is produced, in every
    env and in one."""
    from benchmark.reference.plain.dist import mesh

    old = core.tf32(True)
    try:
        rep_c, outs_c = _replay(ref, env, rec, seed, device, cfg)
    finally:
        core.tf32(old)
    gaps_c = [ref.control_env_gap(env, f) for f in full]
    control = _numbers(ref, _as_program(ref, rep_c, outs_c), outs, rep, params, gaps_c, device)
    faults = [ref.fault_gaps(env, f) for f in full]
    del rep_c, outs_c
    rows = mesh.minibatch_rows
    mesh.minibatch_rows = lambda *a: [r[: len(r) // 2] for r in rows(*a)]
    try:
        rep_h, outs_h = _replay(ref, env, rec, seed, device, cfg)
    finally:
        mesh.minibatch_rows = rows
    half = _numbers(ref, _as_program(ref, rep_h, outs_h), outs, rep, params, [], device)
    for k in core.env_numbers([]):
        half.pop(k)
    read = {k: core.env_numbers([g[k] for g in faults]) for k in faults[0]}
    return dict(tf32=control, half_batch=half, unchanged=dict(read["unchanged"], change_gap=1.0),
                altered=read["altered"], one_env=read["one_env"])


def _numbers(ref, prog: Dict, outs, rep, params, env_gaps, device) -> Dict[str, float]:
    """The numbers compared: the widest env-step gap and the outlying envs,
    the widest action gap and loss gap, the worst leaf's first-gradient gap
    and parameter-change gap."""
    loss = max(core.loss_gap(pm, o["metrics"], ref.LOSS_KEYS)
               for pm, o in zip(prog["metrics"], outs))
    action = max(core.rel_gap(pa.to(device), o[k].to(device))
                 for k in ref.ACTION_KEYS for pa, o in zip(prog["actions"][k], outs))
    grad = core.leaf_norm_gap(prog["first_grad"], rep.first_grad)
    keep = [k for k in core.moving_leaves(rep.first_grad) if k in params]
    d_prog = {k: prog["params"][k] - prog["params0"][k] for k in keep}
    d_ref = {k: params[k] - rep.params0[k] for k in keep}
    change = core.leaf_norm_gap(d_prog, d_ref)
    return dict(core.env_numbers(env_gaps), action_gap=action, loss_gap=loss, grad_gap=grad["gap"],
                change_gap=change["gap"])


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, traced: bool, device: str = "cuda",
        control: bool = False, fault=None) -> Dict:
    """One run: set-up, the window, (traced) the profiled slice, then the
    reference. `fault`, for the harness's own tests, breaks the program
    after set-up's build (a callable taking the runner)."""
    t0 = time.perf_counter()
    runner = build(cfg, seed, device)
    if fault is not None:
        fault(runner)
    rec = record_iterations(runner, cfg, traffic, seed)
    common.sync(device)
    setup_s = time.perf_counter() - t0
    win = window(runner, cfg, seconds, device, traced)
    readings = dict(win)
    if traced and device == "cuda":
        readings["slice"] = profiled_slice(runner, cfg, traffic["profile_steps"],
                                           win["k1_shapes"])
    del runner
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judged = judge(cfg, rec, seed, device, control)
    judged["seconds"] = time.perf_counter() - t_judge
    e2e = dict(setup_s=setup_s, train_env_steps_per_s=win["env_steps"] / win["window_s"])
    return dict(end_to_end=e2e, readings=readings, memory_peak=win["memory_peak"],
                attempted=win["iterations"], numbers=judged["numbers"], judged=judged)
