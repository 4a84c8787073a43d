"""The port's bench (agility_tpu_torch/bench.py) against the JAX package's
root bench.py: the same configurations (built here as bench.py:115-132 and
:185-186 build them; importing bench.py itself would initialise a JAX
backend and set the global compilation cache, bench.py:68-70, :97), the
same environment knobs and defaults, and on the CPU at 8 envs the same
iteration indices and accounting of its lines."""
import dataclasses

import pytest
import torch

from agility_tpu.envs import config as jcfg
from agility_tpu.envs import tsc_config as jtsc
from agility_tpu.learn import ssinfogail as jgail
from agility_tpu_torch import bench
from agility_tpu_torch.learn.ppo_tsc import TscPPO
from agility_tpu_torch.learn.ssinfogail import SSInfoGAIL

KEYS = {"metric", "value", "unit"}     # the root bench's keys but its vs_baseline


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bbc_cfg(n, cold):
    """bench.py:115-126."""
    cfg = jcfg.Go2LocomotionCfg(env=jcfg.EnvCfg(num_envs=n),
                                terrain=jcfg.TerrainCfg(num_rows=4, num_cols=4, border_size=10.0))
    if cold:
        cfg = dataclasses.replace(cfg, sim=jcfg.SimCfg(warm_start=False, jacobi_iters=10))
    return cfg


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("n", [8, 4096, 6144])
def test_bbc_configs_equal_the_root_bench(n, cold):
    """The BBC env config (BENCH_COLD off and on) and the AlgoCfg (the
    expert preload with and without BENCH_FAST, the ring's rows) field by
    field."""
    want = _jax_bbc_cfg(n, cold)
    assert dataclasses.asdict(bench.bbc_config(n, cold)) == dataclasses.asdict(want)
    for fast in (False, True):
        # bench.py:128-132
        want = jgail.AlgoCfg(num_preload_transitions=4096 if fast else 50_000,
                             disc_replay_buffer_size=(500_000 // n) * n)
        assert dataclasses.asdict(bench.bbc_algo_cfg(n, fast)) == dataclasses.asdict(want)


@pytest.mark.parametrize("n", [8, 6144])
def test_tsc_config_equals_the_root_bench(n):
    cfg = jtsc.Go2AgilityCfg()      # bench.py:185-186
    want = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env, num_envs=n))
    got = bench.tsc_config(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.obstacle.courses == 64 and got.env.disc_obs_len == 2


def test_knob_defaults_are_the_root_benchs():
    assert bench.knobs({}) == dict(envs=4096, tsc_envs=6144, iters=5, tsc=True, fast=False,
                                   cold=False)
    assert bench.knobs({"BENCH_ENVS": "8", "BENCH_TSC_ENVS": "16", "BENCH_ITERS": "2",
                        "BENCH_TSC": "0", "BENCH_FAST": "1", "BENCH_COLD": "1"}) == dict(
        envs=8, tsc_envs=16, iters=2, tsc=False, fast=True, cold=True)


def _spy_iterations(monkeypatch, cls):
    seen = []
    real = cls.train_iteration

    def spy(self, ts, es, disc_hist, it, draws=None):
        seen.append(it)
        return real(self, ts, es, disc_hist, it, draws)

    monkeypatch.setattr(cls, "train_iteration", spy)
    return seen


def _check_line(out, dt, metric, steps_per_iter):
    assert set(out) == KEYS | {"device", "iter_ms"}
    assert out["metric"] == metric and out["unit"] == "env-steps/s" and out["device"] == "cpu"
    assert out["value"] == round(steps_per_iter / dt, 1) > 0
    assert len(out["iter_ms"]) == 1 and out["iter_ms"][0] > 0


def test_bench_bbc_line_on_cpu(monkeypatch):
    """bench_bbc at 8 envs, one timed iteration: one warm iteration at it =
    1, the timed one at it = 2, and the root bench's accounting."""
    seen = _spy_iterations(monkeypatch, SSInfoGAIL)
    out, dt = bench.bench_bbc("cpu", num_envs=8, iters=1, fast=True)
    assert seen == [1, 2]
    _check_line(out, dt, "env_steps_per_sec", 24 * 8)


def test_bench_tsc_line_on_cpu(monkeypatch):
    """bench_tsc at 8 envs on 2 courses, one timed iteration."""
    seen = _spy_iterations(monkeypatch, TscPPO)
    cfg = bench.tsc_config(8)
    cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=2))
    out, dt = bench.bench_tsc("cpu", iters=1, cfg=cfg)
    assert seen == [1, 2]
    _check_line(out, dt, "tsc_env_steps_per_sec", 24 * 8)


@pytest.mark.parametrize("tsc", ["1", "0"])
def test_main_without_a_card_fails_with_well_formed_lines(monkeypatch, capsys, tsc):
    """--device cuda with no card: a line with value 0 and "error" for each
    stack it would have run, then exit 1 (it never runs on the CPU
    unasked)."""
    import json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_TSC", tsc)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    want = ["env_steps_per_sec"] + (["tsc_env_steps_per_sec"] if tsc == "1" else [])
    assert [x["metric"] for x in lines] == want
    for x in lines:
        assert set(x) == KEYS | {"error"} and x["value"] == 0.0 and "CUDA" in x["error"]
