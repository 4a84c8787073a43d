"""The port's TSC teacher runner and entry point on the CPU at a 4-env,
2-course size, no JAX needed (the JAX-side checks of the slim checkpoint
and every trainer stage are in tests/test_torch_tsc_train.py): learning,
the save cadence's files, exact resume from the full state, the slim
fallback, and cli/train_tsc's flags."""
import os

import numpy as np
import pytest
import torch

from agility_tpu_torch.cli import train_tsc
from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg
from agility_tpu_torch.learn.runner_tsc import TscOnPolicyRunner
from agility_tpu_torch.learn.ssinfogail import metrics_to_host

N = 4
KW = dict(num_steps_per_env=4, num_learning_epochs=2, num_mini_batches=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(log_dir, seed=0, **kw):
    return TscOnPolicyRunner(Go2AgilityEnv(tsc_smoke_cfg(N, 2), "cpu", seed=seed),
                             ckpt.load_bbc_frozen(None, seed=0), TscAlgoCfg(**{**KW, **kw}),
                             log_dir=log_dir, seed=seed)


def _run_iters(runner, n):
    """n iterations without the runner's logging; the metrics of each."""
    out = []
    for it in range(runner.current_iteration, runner.current_iteration + n):
        runner.train_state, runner.env_state, runner.disc_hist, m = runner.alg.train_iteration(
            runner.train_state, runner.env_state, runner.disc_hist, it)
        out.append(metrics_to_host(m))
    runner.current_iteration += n
    return out


def _params(ts):
    return {f"{k}.{n}": p.detach().clone() for k in ("ac", "est")
            for n, p in getattr(ts, k).state_dict().items()}


def _moments(ts):
    """Every Adam moment and step count of the three optimisers."""
    out = {}
    for k in ("ac_opt", "hist_opt", "est_opt"):
        for i, st in getattr(ts, k).state_dict()["state"].items():
            for name, v in st.items():
                out[f"{k}.{i}.{name}"] = v.clone()
    return out


def test_tsc_training_runs_and_is_finite(tmp_path):
    """learn(3): finite parameters and metrics; DAgger at iteration 0 only
    (3 PPO + 1 DAgger bumps of the priv-reg counter, the history encoder
    moved); std at or above min_std; the final slim and full checkpoints."""
    r = _runner(str(tmp_path))
    p0 = _params(r.train_state)
    r.learn(3, log_every=1)
    ts = r.train_state
    p = _params(ts)
    assert all(bool(torch.isfinite(v).all()) for v in p.values())
    m = metrics_to_host(r.last_metrics)
    assert all(np.isfinite(v) for v in m.values())
    assert {"rollout/r_total", "rollout/done", "rollout/success", "ppo/kl",
            "ppo/priv_reg"} <= set(m)
    assert ts.priv_reg_counter == 4 and r.current_iteration == 3
    assert any(not torch.equal(p[k], p0[k]) for k in p if ".history_encoder." in k)
    assert float(ts.ac.std.detach().min()) >= np.float32(r.cfg.min_std)
    names = sorted(os.listdir(tmp_path))
    assert names[0].startswith("events.out.tfevents")
    assert names[1:] == ["model_3.msgpack", "state_3.pt"]


def test_tsc_resume_is_bit_identical(tmp_path):
    """save at 2, load into a fresh runner: parameters, every optimiser
    moment, the learning rate, the counter and the env state equal; one
    more iteration on each: metrics and parameters equal bit for bit."""
    log_dir = str(tmp_path / "run")
    r1 = _runner(log_dir, seed=3)
    _run_iters(r1, 2)
    r1.save(r1.current_iteration)
    r2 = _runner(log_dir, seed=5)
    path = ckpt.latest(log_dir)
    assert path.endswith("model_2.msgpack") and ckpt.sibling_state(path) is not None
    r2.load(path)
    assert r2.current_iteration == 2
    a, b = _params(r1.train_state), _params(r2.train_state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    ma, mb = _moments(r1.train_state), _moments(r2.train_state)
    assert ma.keys() == mb.keys() and len(ma) > 0
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert (r2.train_state.lr, r2.train_state.priv_reg_counter) == (
        r1.train_state.lr, r1.train_state.priv_reg_counter) and r1.train_state.priv_reg_counter == 3
    assert torch.equal(r1.env_state.sim.base_pos, r2.env_state.sim.base_pos)
    assert torch.equal(r1.disc_hist, r2.disc_hist)

    assert _run_iters(r1, 1) == _run_iters(r2, 1)
    a, b = _params(r1.train_state), _params(r2.train_state)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tsc_slim_fallback_restores_weights(tmp_path):
    """Without its state file a slim checkpoint restores the actor-critic,
    the estimator, the learning rate and the iteration."""
    log_dir = str(tmp_path / "run")
    r1 = _runner(log_dir, seed=3)
    _run_iters(r1, 1)
    r1.train_state.lr = np.float32(0.00321)
    path = r1.save(r1.current_iteration)
    os.remove(ckpt.sibling_state(path))
    r2 = _runner(log_dir, seed=4)
    r2.load(path)
    a, b = _params(r1.train_state), _params(r2.train_state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert r2.train_state.lr == np.float32(0.00321) and r2.current_iteration == 1


def test_train_tsc_flags(tmp_path):
    """The CLI's flags reach the config; --use_camera builds the depth
    student's runner at depth.camera_num_envs (256) envs unless --num_envs
    says otherwise, in <log_root>/<proj_name>/<exptid>; --device cuda exits
    where torch sees no card."""
    args = train_tsc.get_args([
        "--debug", "--device", "cpu", "--num_envs", "4", "--courses", "2",
        "--randomize_start", "--randomize_base_mass", "--randomize_base_com",
        "--push_robots", "--obstacle_curriculum", "--log_root", str(tmp_path)])
    r = train_tsc.build(args)
    cfg = r.env.cfg
    assert cfg.env.num_envs == 4 and cfg.obstacle.courses == 2
    assert cfg.env.randomize_start and cfg.obstacle.curriculum
    assert (cfg.domain_rand.randomize_base_mass, cfg.domain_rand.randomize_base_com,
            cfg.domain_rand.push_robots) == (True, True, True)
    assert r.log_dir == os.path.join(str(tmp_path), "agility", "000")
    assert dict(vars(r.cfg)) == dict(vars(TscAlgoCfg()))
    v = train_tsc.build(train_tsc.get_args(["--use_camera", "--device", "cpu", "--courses", "2",
                                            "--log_root", str(tmp_path), "--exptid", "vis"]))
    assert type(v).__name__ == "VisionRunner" and v.env.num_envs == 256
    assert v.log_dir == os.path.join(str(tmp_path), "agility", "vis")
    assert v.train_state.hidden.shape == (256, 512) and v.env_state.obs_buf.shape == (256, 800)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            train_tsc.build(train_tsc.get_args(["--debug"]))
