"""The harness end to end on the CPU at a tiny size (8 envs on a 2 x 2
terrain), below its look for a chip: the program's runs agree with the
plain reference, and runs with the timed path broken underneath come out
not correct."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import main, play, train

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = json.load(open(os.path.join(HERE, "bbc_tiny.json")))
TRAIN = {"bbc_train": "bbc_tiny.json", "tsc_train": "tsc_tiny.json"}
SEED = 2**31 + 77   # wider than 32 signed bits


def traffic(name, **kw):
    t = json.load(open(os.path.join(main.BENCH_DIR, "traffic", name + ".json")))
    t.update(kw)
    return t


def limits(cell):
    return json.load(open(os.path.join(main.BENCH_DIR, "limits", cell + ".json")))["limits"]


def correct(res, cell):
    return all(c["ok"] for c in main.checks(res["numbers"], limits(cell)).values())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_train(cell="bbc_train", fault=None):
    cfg = json.load(open(os.path.join(HERE, TRAIN[cell])))
    return train.run(cfg, traffic("train"), SEED, 0.5, False, "cpu", fault=fault)


def run_play(fault=None):
    return play.run(TINY, traffic("play_trot", check_range=6), SEED, 2.0, False, "cpu",
                    fault=fault)


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_train_matches_the_reference_on_the_cpu(cell):
    res = run_train(cell)
    assert res["numbers"] == {k: 0.0 for k in res["numbers"]}   # the same plain path
    assert correct(res, cell)
    assert res["end_to_end"]["train_env_steps_per_s"] > 0 and res["attempted"] >= 1


def test_play_matches_the_reference_on_the_cpu():
    res = run_play()
    assert res["numbers"] == {"step_gap": 0.0, "env_outliers": 0, "action_gap": 0.0}
    assert correct(res, "bbc_play")
    assert res["end_to_end"]["play_step_ms_p90"] > 0


def _freeze_optimisers(runner):
    """A training step that returns its state unchanged: no optimiser moves."""
    ts = runner.train_state
    for attr in ("ac_opt", "est_opt", "hist_opt", "disc_opt_d", "disc_opt_qe", "disc_opt_qc"):
        opt = getattr(ts, attr, None)
        if opt is None:
            continue
        opt.__class__ = type("Frozen", (opt.__class__,), {"step": lambda self, *a, **k: None})


def _altered_env_step(cls):
    """Each env's observation taken from the next env: an index off by one."""
    orig = cls.step

    def step(self, state, actions):
        new, out = orig(self, state, actions)
        return new._replace(obs_buf=torch.roll(new.obs_buf, 1, dims=0)), out
    return step


def _one_env_step(cls):
    """Env 0's observation taken from env 1: an answer altered in one env,
    which the trimmed gap leaves out and the outlying envs count."""
    orig = cls.step

    def step(self, state, actions):
        new, out = orig(self, state, actions)
        obs = new.obs_buf.clone()
        obs[0] = obs[1]
        return new._replace(obs_buf=obs), out
    return step


def _caught_by_the_count_alone(res, cell):
    chk = main.checks(res["numbers"], limits(cell))
    gap = "step_gap" if cell == "bbc_play" else "env_step_gap"
    return chk[gap]["ok"] and not chk["env_outliers"]["ok"]


@pytest.mark.parametrize("cell", sorted(TRAIN))
def test_train_faults_come_out_not_correct(monkeypatch, cell):
    """A training step that returns its state unchanged, half of each
    minibatch left out, an env step's answer altered where it is produced,
    in every env and in one (one chip: no exchange between chips to leave
    out)."""
    from agility_tpu_torch.dist import mesh
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv

    assert not correct(run_train(cell, fault=_freeze_optimisers), cell)

    halves = mesh.minibatch_rows
    monkeypatch.setattr(mesh, "minibatch_rows",
                        lambda *a: [r[: len(r) // 2] for r in halves(*a)])
    assert not correct(run_train(cell), cell)
    monkeypatch.undo()

    env_cls = Go2LocomotionEnv if cell == "bbc_train" else Go2AgilityEnv
    monkeypatch.setattr(env_cls, "step", _altered_env_step(env_cls))
    assert not correct(run_train(cell), cell)
    monkeypatch.undo()

    monkeypatch.setattr(env_cls, "step", _one_env_step(env_cls))
    res = run_train(cell)
    assert not correct(res, cell) and _caught_by_the_count_alone(res, cell)


def test_play_faults_come_out_not_correct(monkeypatch):
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.policy import InferencePolicy

    orig_step = Go2LocomotionEnv.step

    def stale(self, state, actions):
        _, out = orig_step(self, state, actions)
        return state, out
    monkeypatch.setattr(Go2LocomotionEnv, "step", stale)
    assert not correct(run_play(), "bbc_play")
    monkeypatch.undo()

    orig_fwd = InferencePolicy.forward

    def altered(self, obs):
        a = orig_fwd(self, obs).clone()
        a[0, 0] += 0.5
        return a
    monkeypatch.setattr(InferencePolicy, "forward", altered)
    assert not correct(run_play(), "bbc_play")
    monkeypatch.undo()

    monkeypatch.setattr(Go2LocomotionEnv, "step", _one_env_step(Go2LocomotionEnv))
    res = run_play()
    assert not correct(res, "bbc_play") and _caught_by_the_count_alone(res, "bbc_play")


def test_imports_keep_apart():
    """What a run loads has no top-level name jax, jaxlib, flax or
    agility_tpu; the reference loads nothing of agility_tpu_torch."""
    code = (
        "import sys, json; sys.path.insert(0, %r); import torch; torch.set_num_threads(2)\n"
        "from benchmark.reference import bbc\n"
        "ref_only = sorted({m.split('.')[0] for m in sys.modules} & {'agility_tpu_torch', "
        "'agility_tpu', 'jax'})\n"
        "from benchmark.harness import main, play\n"
        "cfg = json.load(open(%r)); tr = json.load(open(%r)); tr['check_range'] = 2\n"
        "play.run(cfg, tr, 5, 0.2, False, 'cpu')\n"
        "print(json.dumps([ref_only, main.forbidden_modules(), "
        "'agility_tpu_torch' in sys.modules]))\n"
    ) % (main.ROOT, os.path.join(HERE, "bbc_tiny.json"),
         os.path.join(main.BENCH_DIR, "traffic", "play_trot.json"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=main.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    ref_only, forbidden, ported = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref_only == [] and forbidden == [] and ported


def test_run_exits_without_a_card_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bbc_play",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=main.ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
