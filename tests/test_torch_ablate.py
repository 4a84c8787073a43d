"""The port's env-layer ablation tools (agility_tpu_torch/tools/
bench_env_ablate.py, bench_env_ablate_tsc.py) on the CPU at 8 envs: their
variants are the JAX tools' (labels read from tools/bench_env_ablate*.py
with ast, without importing them), each stub returns the real method's
shapes and dtypes, env.step reaches the patched method, and after every
variant has run (T = 2) the env steps as a fresh one does."""
import ast
import dataclasses
import os

import pytest
import torch

from agility_tpu_torch import bench
from agility_tpu_torch.envs import mocap
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
from agility_tpu_torch.tools import bench_env_ablate as bbc_tool
from agility_tpu_torch.tools import bench_env_ablate_tsc as tsc_tool
from agility_tpu_torch.tools.bench_env_ablate import act, patched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tsc_cfg():
    cfg = bench.tsc_config(N)
    return dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=2))


CASES = {"bbc": (lambda: Go2LocomotionEnv(bench.bbc_config(N), "cpu"), bbc_tool,
                 "tools/bench_env_ablate.py"),
         "tsc": (lambda: Go2AgilityEnv(_tsc_cfg(), "cpu"), tsc_tool,
                 "tools/bench_env_ablate_tsc.py")}


def _jax_labels(rel):
    """The labels the JAX tool passes to bench(env, label, ...), in order."""
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "bench"]
    return [c.args[1].value for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset))]


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    return []


def _layout(x):
    return [(tuple(t.shape), t.dtype) for t in _leaves(x)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_labels_are_the_jax_tools(case):
    make, tool, rel = CASES[case]
    assert [label for label, _ in tool.variants(make())] == _jax_labels(rel)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stubs_return_the_real_methods_shapes(case):
    """Every stubbed method's stand-in, called on the inputs the real method
    got in a real step, returns the real output's shapes and dtypes."""
    make, tool, _ = CASES[case]
    env = make()
    s = env.init_state()
    names = {k for _, patches in tool.variants(env) for k in patches if k != "cfg"}
    calls = {}

    def record(name, method):
        def rec(*args, **kwargs):
            out = method(*args, **kwargs)
            calls.setdefault(name, (args, kwargs, out))
            return out
        return rec

    with patched(env, **{k: record(k, getattr(env, k)) for k in names}):
        env.step(s, act(s))
    assert set(calls) == names
    for label, patches in tool.variants(env):
        for name, stub in patches.items():
            if name == "cfg":
                continue
            args, kwargs, real = calls[name]
            assert _layout(stub(*args, **kwargs)) == _layout(real), (label, name)
            assert type(stub(*args, **kwargs)) is type(real), (label, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_calls_the_patched_method(case, monkeypatch):
    """A method patched on the instance is the one env.step calls; the
    config patch takes the reset off the mocap frames."""
    make, tool, _ = CASES[case]
    env = make()
    s = env.init_state()
    frames = []
    real_frames = mocap.MotionData.sample_frames
    monkeypatch.setattr(mocap.MotionData, "sample_frames",
                        lambda self, *a, **kw: frames.append(1) or real_frames(self, *a, **kw))
    for label, patches in tool.variants(env):
        hits = []

        def spy(stub):
            return lambda *a, **kw: hits.append(1) or stub(*a, **kw)

        frames.clear()
        with patched(env, **{k: v if k == "cfg" else spy(v) for k, v in patches.items()}):
            env.step(s, act(s))
        methods = [k for k in patches if k != "cfg"]
        assert bool(hits) == bool(methods), label
        if "cfg" in patches:
            assert not frames, label
        elif case == "bbc" and "_reset_where" not in patches:
            assert frames, label


@pytest.mark.parametrize("case", sorted(CASES))
def test_ablate_leaves_the_env_as_a_fresh_one(case):
    """After every variant ran (T = 2, one rep), the env holds no stub and
    its own config, and its next step equals a fresh env's from the same
    state and generator state."""
    make, tool, _ = CASES[case]
    env = make()
    cfg = env.cfg
    rows, again = tool.ablate(env, T=2, reps=1)
    assert again is None
    assert [r["label"] for r in rows] == [label for label, _ in tool.variants(env)]
    for r in rows:
        assert r["finite"] and r["ms"] > 0 and r["ops"] is None, r
        assert r["launches"] == dict(contact_lcp=0, terrain_window=0, scandots=0, per_env_windows=0,
                                    band_windows=0, free_dynamics=0)
    assert env.cfg is cfg
    assert not {"_reset_where", "_compute_observations", "_compute_reward",
                "_center_root_height", "_measure_heights"} & set(vars(env))
    fresh = make()
    s = fresh.init_state()
    g = fresh.gen.get_state()
    outs = []
    for e in (env, fresh):
        e.gen.set_state(g)
        with torch.no_grad():
            outs.append(_leaves(e.step(s, act(s))))
    assert len(outs[0]) == len(outs[1]) > 10
    assert all(torch.equal(a, b) for a, b in zip(*outs))
