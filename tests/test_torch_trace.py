"""The port's spans (agility_tpu_torch/trace.py) on the CPU at a small size:
off they cost nothing and change nothing; on, they nest layer under layer,
leave every result bit-identical, keep the trainers' timer sequence, and
enter the profiler's record on its clock.  Also the span tool's arithmetic
(tools/span_slice.py) on synthetic slices, and the runner's and play's
outputs of the spans."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from agility_tpu_torch import trace
from agility_tpu_torch.envs.config import smoke_cfg
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg
from agility_tpu_torch.learn.runner import OnPolicyRunner, write_spans
from agility_tpu_torch.learn.runner_tsc import TscOnPolicyRunner
from agility_tpu_torch.learn.ssinfogail import AlgoCfg
from agility_tpu_torch.tools import span_slice as ss

N = 4
ENVS = {"bbc": lambda: Go2LocomotionEnv(smoke_cfg(N), "cpu"),
        "tsc": lambda: Go2AgilityEnv(tsc_smoke_cfg(N, 2), "cpu")}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no records."""
    trace.disable()
    trace.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def envs():
    """Each env with a state one step past init_state."""
    out = {}
    for kind, make in ENVS.items():
        env = make()
        out[kind] = (env, env.init_state())
    return out


def _actions(seed=0):
    return 0.3 * torch.randn(N, 12, generator=torch.Generator().manual_seed(seed))


def _step(env, state, gen_state):
    env.gen.set_state(gen_state)
    return env.step(state, _actions())


# ---------------------------------------------------------------------------
# off: the shared no-op, nothing recorded, no event, annotation or synchronise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["span", "spanned", "mark"])
def test_off_records_nothing(kind):
    """With tracing off `span` hands back one shared object, and no span,
    decorated call or mark leaves a record."""
    if kind == "span":
        a, b = trace.span("x"), trace.span("y", sync=True)
        assert a is b
        with a:
            pass
    elif kind == "spanned":
        assert trace.spanned("x")(lambda v: v + 1)(1) == 2
    else:
        seen = []
        for stage in ("start", "rollout", "end"):
            trace.mark(seen.append, stage)
        assert seen == ["start", "rollout", "end"]
    assert trace.records() == [] and trace.summary() == {}


@pytest.mark.parametrize("env_kind", sorted(ENVS))
def test_off_launches_nothing(envs, monkeypatch, env_kind):
    """A whole env step with tracing off creates no CUDA event, enters no
    profiler annotation and synchronises nothing."""
    def refuse(*a, **k):
        raise AssertionError("tracing off touched the device or the profiler")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    env, state = envs[env_kind]
    env.step(state, _actions())
    assert trace.records() == []


# ---------------------------------------------------------------------------
# on: the same results, spans nested layer under layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_kind", sorted(ENVS))
def test_step_bit_identical_with_tracing(envs, env_kind):
    """One env step from the same state and generator state gives the same
    state and reward, bit for bit, with tracing on and off."""
    env, state = envs[env_kind]
    g = env.gen.get_state()
    off_state, off_out = _step(env, state, g)
    trace.enable("cpu")
    on_state, on_out = _step(env, state, g)
    trace.disable()
    assert torch.equal(off_out.rew, on_out.rew)
    for name, a, b in zip(off_state._fields, off_state, on_state):
        for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name


@pytest.mark.parametrize("env_kind", sorted(ENVS))
def test_env_step_nesting(envs, env_kind):
    """env.step > engine > engine.substep x decimation > free_dynamics,
    contact, integrate; the terrain window once a step under the engine;
    the scandots (K3) under env.obs on the TSC only."""
    env, state = envs[env_kind]
    trace.enable("cpu")
    env.step(state, _actions())
    recs = trace.records()
    D = env.engine_cfg.decimation
    parents = {}
    for r in recs:
        parents.setdefault(r.name, set()).add(r.parent)
        assert r.device_ms is None and r.host_ms >= 0
    counts = {n: sum(r.name == n for r in recs) for n in parents}
    want = {"env.step": 1, "engine": 1, "engine.terrain_window": 1, "engine.substep": D,
            "engine.free_dynamics": D, "engine.contact": D, "engine.integrate": D,
            "env.reward": 1, "env.reset": 1, "env.obs": 1}
    if env_kind == "tsc":
        want["env.scandots"] = 1
    assert counts == want
    assert parents == {
        "env.step": {None}, "engine": {"env.step"}, "engine.terrain_window": {"engine"},
        "engine.substep": {"engine"}, "engine.free_dynamics": {"engine.substep"},
        "engine.contact": {"engine.substep"}, "engine.integrate": {"engine.substep"},
        "env.reward": {"env.step"}, "env.reset": {"env.step"}, "env.obs": {"env.step"},
        **({"env.scandots": {"env.obs"}} if env_kind == "tsc" else {})}
    # a child closes before its parent, and the substep's parts in order
    order = [r.name for r in recs]
    assert order[-1] == "env.step" and order.index("engine") < order.index("env.step")
    assert order[:5] == ["engine.terrain_window", "engine.free_dynamics", "engine.contact",
                         "engine.integrate", "engine.substep"]
    s = trace.summary()
    assert s["engine.substep"]["count"] == D and s["engine"]["parent"] == "env.step"
    assert s["engine"]["host_ms"] >= sum(s[n]["host_ms"] for n in (
        "engine.free_dynamics", "engine.contact", "engine.integrate", "engine.terrain_window"))


def test_profiler_holds_spans_on_its_clock(envs):
    """Under a CPU torch.profiler the spans are user annotations, nested as
    the records are, with the env's aten operators inside the engine's
    interval: one clock for the spans and the operators."""
    env, state = envs["bbc"]
    trace.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        env.step(state, _actions())
    events = list(prof.profiler.kineto_results.events())
    ann = {}
    for e in events:
        if e.is_user_annotation():
            ann.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    D = env.engine_cfg.decimation
    assert {n: len(v) for n, v in ann.items()} == {
        n: r["count"] for n, r in trace.summary().items()}
    assert len(ann["engine.substep"]) == D
    (e0, e1), = ann["engine"]
    (s0, s1), = ann["env.step"]
    assert s0 <= e0 < e1 <= s1
    for a, b in ann["engine.substep"]:
        assert e0 <= a < b <= e1
    inside = [e for e in events if e.name().startswith("aten::")
              and e0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= e1]
    assert len(inside) > 100


# ---------------------------------------------------------------------------
# the trainers' marks
# ---------------------------------------------------------------------------


def test_mark_closes_the_stage_it_names():
    """A mark closes the span open since the previous mark under the stage's
    name and opens the next; "start" drops what was open, "end" opens
    nothing; spans opened in between are the stage's children."""
    seen = []
    trace.enable("cpu")
    for stage in ("start", "draw"):
        trace.mark(seen.append, stage)
    with trace.span("rollout.act"):
        pass
    for stage in ("rollout", "ppo", "start", "draw", "end"):
        trace.mark(seen.append, stage)
    assert seen == ["start", "draw", "rollout", "ppo", "start", "draw", "end"]
    assert [(r.name, r.parent) for r in trace.records()] == [
        ("train.draw", None), ("rollout.act", "train.rollout"), ("train.rollout", None),
        ("train.ppo", None), ("train.draw", None), ("train.end", None)]


TRAINERS = {
    "bbc": (lambda: OnPolicyRunner(ENVS["bbc"](), AlgoCfg(
        num_steps_per_env=2, num_preload_transitions=64, disc_replay_buffer_size=64,
        num_learning_epochs=1, num_mini_batches=2), log_dir=None, seed=0),
        ["start", "draw", "rollout", "gae", "ppo", "disc", "dagger"]),
    "tsc": (lambda: TscOnPolicyRunner(ENVS["tsc"](), ckpt.load_bbc_frozen(None, seed=0),
                                      TscAlgoCfg(num_steps_per_env=2, num_learning_epochs=1,
                                                 num_mini_batches=2), log_dir=None, seed=0),
            ["start", "draw", "rollout", "gae", "ppo", "dagger"]),
}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_train_iteration_marks(trainer):
    """One train_iteration (it 0: DAgger runs) hands the timer the same stage
    sequence with tracing on as off, and leaves one span per stage, each the
    parent of that stage's spans."""
    make, want = TRAINERS[trainer]
    runner = make()
    seqs = []
    for on in (False, True):
        if on:
            trace.enable("cpu")
        seen = []
        runner.alg.timer = seen.append
        runner.alg.train_iteration(runner.train_state, runner.env_state, runner.disc_hist, 0)
        seqs.append(seen)
    assert seqs[0] == seqs[1] == want
    recs = trace.records()
    stages = [r.name for r in recs if r.name.startswith("train.")]
    assert stages == [f"train.{s}" for s in want[1:]]
    by = {r.name: r.parent for r in recs}
    assert by["env.step"] == by["rollout.act"] == by["rollout.disc_reward"] == "train.rollout"
    if trainer == "tsc":
        assert by["rollout.set_commands"] == by["rollout.bbc_act"] == "rollout.act"


# ---------------------------------------------------------------------------
# what reads the spans: the runner's scalars, play's table
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self):
        self.scalars = {}

    def scalar(self, tag, value, step):
        self.scalars[tag] = (value, step)


@pytest.mark.parametrize("writer", [True, False])
def test_write_spans(writer):
    """At a log point the runner writes each span's ms per iteration as
    perf/<span>_ms and forgets the records; without a writer it leaves
    them; with tracing off it writes nothing."""
    w = _Writer() if writer else None
    write_spans(w, 5, 2)
    trace.enable("cpu")
    for _ in range(4):
        with trace.span("engine"):
            pass
    host = trace.summary()["engine"]["host_ms"]
    write_spans(w, 7, 2)
    if writer:
        assert w.scalars == {"perf/engine_ms": (pytest.approx(host / 2), 7)}
        assert trace.records() == []
    else:
        assert len(trace.records()) == 4


def test_play_prints_spans(capsys):
    """play_bbc --trace prints each span's calls and ms at its end (build
    spans included), at 4 envs for 3 steps on the CPU."""
    from agility_tpu_torch.cli import play_bbc

    play_bbc.run(play_bbc.get_args(["--device", "cpu", "--num_envs", "4", "--steps", "3",
                                    "--checkpoint", "logs/bbc_r5/bbc_final.msgpack",
                                    "--trace"]))
    lines = {ln.split()[1]: ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("span ")}
    assert {"build", "build.env", "build.checkpoint", "policy", "env.step", "engine",
            "engine.substep"} <= set(lines)
    assert lines["engine"][2] == "4" and lines["policy"][2] == "3"     # init_state's step too
    assert lines["build.env"][-1] == "build)"


# ---------------------------------------------------------------------------
# tools/span_slice.py's arithmetic, on synthetic slices (seconds)
# ---------------------------------------------------------------------------


SPANS = [(0.0, 10.0, "env.step"), (1.0, 8.0, "engine"), (2.0, 4.0, "engine.free_dynamics"),
         (5.0, 6.0, "engine.contact")]


@pytest.mark.parametrize("case", ["nested", "outside", "empty"])
def test_idle_by_span(case):
    """Each device idle gap goes, piece by piece, to the innermost span open
    over it; gaps under no span go to NONE; no gaps, nothing."""
    if case == "nested":
        device = [(0.5, 1.5), (3.0, 3.5), (5.5, 9.0)]
        # gaps: 1.5-3.0 (engine 1.5-2, free 2-3), 3.5-5.5 (free 3.5-4, engine 4-5, contact 5-5.5)
        got = ss.idle_by_span(device, SPANS)
        assert got == pytest.approx({"engine": 1.5, "engine.free_dynamics": 1.5,
                                     "engine.contact": 0.5})
    elif case == "outside":
        got = ss.idle_by_span([(9.0, 9.5), (11.0, 12.0)], SPANS)
        assert got == pytest.approx({"env.step": 0.5, ss.NONE: 1.0})
    else:
        assert ss.idle_by_span([(0.0, 1.0)], SPANS) == {}
        assert ss.idle_by_span([(0.0, 1.0), (2.0, 3.0)], []) == {ss.NONE: 1.0}


@pytest.mark.parametrize("case", ["matched", "no_span", "no_launch"])
def test_issue_us_per_op(case):
    """Host µs of the `engine` spans over the device ops whose launch (found
    by correlation id) starts inside them: an op launched outside every
    engine span, or with no launch found, does not count; no span, None."""
    spans = [(1.0, 1.001, "engine"), (2.0, 2.002, "engine"), (1.0, 3.0, "env.step")]
    launches = {1: 1.0002, 2: 1.0009, 3: 2.0001, 4: 1.5, 5: 2.5}
    if case == "matched":
        # ops 1-3 launched inside an engine span, 4 and 5 outside, 6 has no launch
        got = ss.issue_us_per_op(spans, "engine", [1, 2, 3, 4, 5, 6], launches)
        assert got == pytest.approx(1e6 * 0.003 / 3)
    elif case == "no_span":
        assert ss.issue_us_per_op(spans, "policy", [1, 2], launches) is None
    else:
        assert ss.issue_us_per_op(spans, "engine", [4, 5, 6], launches) is None


def test_by_innermost():
    """Each span's own time (its children's left out) and the launches that
    fall where it is the innermost span; a launch under no span goes to
    NONE."""
    own, count = ss.by_innermost(SPANS, [0.5, 1.5, 2.5, 3.9, 5.5, 9.0, 11.0])
    assert own == pytest.approx({"env.step": 3.0, "engine": 4.0, "engine.free_dynamics": 2.0,
                                 "engine.contact": 1.0})
    assert count == {"env.step": 2, "engine": 1, "engine.free_dynamics": 2,
                     "engine.contact": 1, ss.NONE: 1}


def test_env_self_ms_and_per_step():
    """env.step less its engine child, a control step; the per-step table;
    nothing to read gives None and an empty table."""
    R = trace.Record
    recs = [R("engine", "env.step", 9.0, 8.0), R("env.obs", "env.step", 1.0, 0.5),
            R("env.step", None, 12.0, 10.0), R("engine", "env.step", 9.0, 8.5),
            R("env.step", None, 11.0, 10.5)]
    assert ss.self_ms(recs, "env.step", "engine", 2) == pytest.approx((20.5 - 16.5) / 2)
    assert ss.self_ms(recs, "policy", "engine", 2) is None
    table = ss.per_step(recs, 2)
    assert table["engine"] == dict(calls=1.0, device_ms=8.25, host_ms=9.0, parent="env.step")
    assert ss.per_step([], 2) == {}
