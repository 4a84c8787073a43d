"""The port's layer-timing tools (agility_tpu_torch/tools/bench_substep,
bench_engine, bench_env, bench_stages, bench_stages_tsc, bench_tsc,
bench_vision, trace_agg, timing) on the CPU at a tiny size: their rows,
labels and knobs are the JAX tools' (read from tools/*.py with ast,
without importing them), each runs at 8 envs (the student at 4) and T = 2,
bench_substep's last row is soa.substep, and trace_agg totals a trace's
durations exactly."""
import ast
import dataclasses
import json
import math
import os

import pytest
import torch

from agility_tpu_torch import bench
from agility_tpu_torch.tools import (bench_engine, bench_env, bench_stages, bench_stages_tsc,
                                     bench_substep, bench_vision, timing, trace_agg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops: one intra-op thread runs them faster than eight and leaves
    the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(name):
    return ast.parse(open(os.path.join(ROOT, "tools", name)).read())


def _knobs(tree):
    """{variable: default} of every os.environ.get(variable, default)."""
    return {c.args[0].value: c.args[1].value for c in ast.walk(tree)
            if isinstance(c, ast.Call) and ast.unparse(c.func) == "os.environ.get"}


def _timed_labels(tree):
    """The labels the JAX tool passes to timed(label, ...), in order."""
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name) and c.func.id == "timed"]
    return [c.args[0].value for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset))]


# (JAX tool, port module, the JAX knobs the port does not take, and why in the port's docstring)
KNOBS = {"bench_substep.py": (bench_substep, ()), "bench_engine.py": (bench_engine, ()),
         "bench_env.py": (bench_env, ()), "bench_stages.py": (bench_stages, ("BENCH_SCAN",)),
         "bench_stages_tsc.py": (bench_stages_tsc, ("BENCH_SCAN",)),
         "bench_vision.py": (bench_vision, ())}


@pytest.mark.parametrize("name", sorted(KNOBS) + ["bench_tsc.py"])
def test_knobs_are_the_jax_tools(name):
    """Every BENCH_* knob of the JAX tool, with its default, except those a
    lax.scan's repeats needed (BENCH_SCAN: rounds take their place)."""
    from agility_tpu_torch.tools import bench_tsc

    mod, dropped = KNOBS.get(name, (bench_tsc, ()))
    jax = _knobs(_tree(name))
    port = _knobs(ast.parse(open(mod.__file__).read()))
    assert port == {k: v for k, v in jax.items() if k not in dropped}
    for k in dropped:
        assert k in mod.__doc__


def test_rows_are_the_jax_tools():
    """bench_substep's six rows and settings, the stage tools' rows, in the
    JAX tools' order (the port adds rows after them)."""
    tree = _tree("bench_substep.py")
    assert list(bench_substep.LABELS[:6]) == _timed_labels(tree)
    assert _timed_labels(tree)[-1] == "+ 10 Jacobi sweeps"
    solve = next(c for c in ast.walk(tree) if isinstance(c, ast.Call)
                 and ast.unparse(c.func) == "soa.jacobi_solve")
    kw = {k.arg: ast.literal_eval(k.value) for k in solve.keywords if k.arg != "iters"}
    assert kw == bench_substep.SOLVE
    dt = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "DT")
    assert ast.literal_eval(dt.value) == bench_substep.DT
    assert bench_stages.labels()[:5] == _timed_labels(_tree("bench_stages.py"))
    assert bench_stages_tsc.labels()[:6] == _timed_labels(_tree("bench_stages_tsc.py"))


def test_substep_tool_runs_and_its_last_row_is_the_substep():
    """Every row at 8 envs, T = 2, one round, finite; K1 not counted on the
    CPU; the last row's step is soa.substep on the same inputs."""
    from agility_tpu_torch.physics import soa
    from agility_tpu_torch.physics.engine import EngineConfig

    rows, pieces = bench_substep.bench("cpu", N=8, T=2, rounds=1)
    assert [r["label"] for r in rows] == list(bench_substep.LABELS)
    assert all(r["finite"] and r["ms"] > 0 and r["ops"] is None for r in rows)
    assert all(not any(r["launches"].values()) for r in rows)
    assert set(pieces) == {p[0] for p in bench_substep.PIECES}
    mc, sd0, inputs = bench_substep.setup(8, "cpu")
    got = bench_substep.steps(mc, inputs)["soa.substep"](sd0)
    cfg = EngineConfig(dt=0.005, jacobi_iters=5, jacobi_relax=0.7)
    want = soa.substep(mc, cfg, sd0, *inputs)[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the JAX closures the rows mirror move the state
    full = bench_substep.steps(mc, inputs)["+ 5 Jacobi sweeps"](sd0)
    assert not torch.equal(full.u, sd0.u)


def test_engine_and_env_tools_run():
    rows = bench_engine.bench("cpu", N=8, T=2, rounds=1)
    assert [r["label"] for r in rows] == ["soa", "vmap"]
    assert all(r["finite"] and r["env_steps_per_s"] > 0 for r in rows)
    assert rows[0]["engine"]["soa"] and not rows[1]["engine"]["soa"]
    assert rows[1]["engine"]["jacobi_iters"] == 10
    row = bench_env.bench("cpu", N=8, T=2, rounds=1)
    assert row["label"] == "env.step" and row["finite"] and row["ms"] > 0


def test_stage_tools_run():
    """Both stage tools at 8 envs (the TSC on 2 courses), T = 2, one round:
    every row finite and the parts below the whole."""
    rows = bench_stages.bench("cpu", 8, T=2, rounds=1)
    assert [r["label"] for r in rows] == bench_stages.labels(2) + ["train_iteration, host clock"]
    ms = {r["label"]: r["ms"] for r in rows}
    assert all(math.isfinite(v) for v in ms.values())
    assert 0 < ms["rollout (2 steps)"] < ms["full train_iteration"]
    assert ms["full train_iteration"] + ms["dagger_update"] <= ms["train_iteration, host clock"]
    cfg = bench.tsc_config(8)
    cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=2))
    rows = bench_stages_tsc.bench("cpu", 8, T=2, rounds=1, cfg=cfg)
    assert [r["label"] for r in rows] == (bench_stages_tsc.labels(2)
                                          + ["train_iteration, host clock"])
    assert all(math.isfinite(r["ms"]) for r in rows)


def test_bench_tsc_profile_and_trace_agg(tmp_path):
    """bench_tsc's BENCH_PROFILE path on the CPU (8 envs, 2 courses, T = 2,
    one timed iteration) writes a chrome trace, which trace_agg reads."""
    from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg

    cfg = bench.tsc_config(8)
    cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=2))
    path = str(tmp_path / "trace.json")
    out, dt = bench.bench_tsc("cpu", iters=1, cfg=cfg, algo_cfg=TscAlgoCfg(num_steps_per_env=2),
                              profile=path)
    assert out["value"] > 0 and os.path.exists(path)
    agg = trace_agg.main([str(tmp_path)])
    assert agg["categories"] == trace_agg.HOST and agg["count"] > 100


def test_trace_agg_totals_a_cpu_trace_exactly(tmp_path, capsys):
    """A tiny CPU trace: the total and each name's ms are the sums of its
    host operators' durations, and the counts their numbers."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    agg = trace_agg.aggregate(trace_agg.load(path))
    assert agg["count"] == len(ops) > 0
    assert agg["total_ms"] == pytest.approx(sum(e["dur"] for e in ops) / 1e3, rel=0, abs=1e-9)
    tanh = [e for e in ops if e["name"] == "aten::tanh"]
    assert agg["calls"]["aten::tanh"] == len(tanh) == 3
    assert agg["ms"]["aten::tanh"] == pytest.approx(sum(e["dur"] for e in tanh) / 1e3,
                                                    rel=0, abs=1e-9)
    trace_agg.main([path])
    assert "total host operator (no device events) time" in capsys.readouterr().out


def test_vision_tool_runs():
    """The student iteration at 4 envs on 2 courses, T = 2, one round."""
    cfg = bench.tsc_config(4)
    cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=2))
    row = bench_vision.bench("cpu", 4, iters=1, T=2, cfg=cfg)
    assert row["finite"] and row["ms"] > 0 and row["peak_bytes"] is None


def test_interleaved_rounds_and_readings():
    """timing.interleaved runs every variant once untimed, then once a round
    in turn; readings become rows; the stage timer splits iterations."""
    order = []
    variants = [timing.Variant("a", lambda: order.append("a"), per=2),
                timing.Variant("b", lambda: order.append("b") or {"b.x": 3.0})]
    rows = timing.interleaved(variants, "cpu", rounds=3)
    assert order == ["a", "b"] + ["a", "b"] * 3
    assert [r["label"] for r in rows] == ["a", "b", "b.x"]
    assert rows[2]["ms"] == rows[2]["ms_min"] == 3.0 and len(rows[0]["rounds"]) == 3
    assert set(rows[0]["launches"]) >= {"per_env_windows", "band_windows"}
    t = timing.StageTimer("cpu")
    for s in ("start", "draw", "rollout", "rollout", "end", "start", "draw", "end"):
        t(s)
    its = t.iterations()
    assert [list(i) for i in its] == [["draw", "rollout", "end"], ["draw", "end"]]
    assert len(t.wall_ms()) == 2 and all(w >= 0 for w in t.wall_ms())
