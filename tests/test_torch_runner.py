"""The port's BBC training runner, checkpoints and the training side of its
env, on the CPU at the 8-env smoke size (no JAX needed: the JAX-side
checks of the slim checkpoint are in tests/test_torch_train.py).

Mirrors tests/test_train_bbc.py, tests/test_checkpoint_resume.py,
tests/test_terminal_disc.py and
tests/test_env_bbc.py::test_expert_disc_features_match_env_features.
"""
import os

import numpy as np
import pytest
import torch

from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.envs import mocap
from agility_tpu_torch.envs.config import smoke_cfg
from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv, compute_disc_features
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn.runner import OnPolicyRunner
from agility_tpu_torch.learn.ssinfogail import AlgoCfg, metrics_to_host
from agility_tpu_torch.physics import soa

N = 8
KW = dict(num_steps_per_env=8, num_preload_transitions=256, disc_replay_buffer_size=512,
          num_learning_epochs=2, num_mini_batches=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(log_dir, seed=0, **kw):
    return OnPolicyRunner(Go2LocomotionEnv(smoke_cfg(N), "cpu"), AlgoCfg(**{**KW, **kw}),
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
    return {f"{k}.{n}": p.detach().clone() for k in ("ac", "est", "disc")
            for n, p in getattr(ts, k).state_dict().items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("bbc_logs"))
    r = _runner(log_dir)
    hist0 = _params(r.train_state)
    r.learn(3, init_at_random_ep_len=False, log_every=1)
    return r, hist0, log_dir


def test_training_runs_and_is_finite(trained):
    r, p0, log_dir = trained
    ts = r.train_state
    p = _params(ts)
    assert all(bool(torch.isfinite(v).all()) for v in p.values())
    assert all(np.isfinite(v) for v in metrics_to_host(r.last_metrics).values())
    assert ts.ring.size == 3 * 8 * N            # iterations x T x N
    assert float(ts.disc_norm.count) > 1.0
    # DAgger ran at iteration 0 only: 3 disc updates + 1 DAgger update
    assert (ts.learning_steps, ts.priv_reg_counter) == (3, 4)
    assert any(not torch.equal(p[k], p0[k]) for k in p if ".history_encoder." in k)
    names = sorted(os.listdir(log_dir))
    assert names[0].startswith("events.out.tfevents")
    assert names[1:] == ["model_3.msgpack", "state_3.pt"]
    acts = r.get_inference_policy()(r.env_state.obs_buf)
    assert acts.shape == (N, 12) and bool(torch.isfinite(acts).all())


def test_resume_is_bit_identical(tmp_path):
    """save at 2, load into a fresh runner, 2 more iterations: metrics and
    parameters equal bit for bit to the uninterrupted run."""
    log_dir = str(tmp_path / "run")
    r1 = _runner(log_dir, seed=3)
    _run_iters(r1, 2)
    r1.save(r1.current_iteration)
    m_cont = _run_iters(r1, 2)

    r2 = _runner(log_dir, seed=3)
    path = ckpt.latest(log_dir)
    assert path.endswith("model_2.msgpack") and ckpt.sibling_state(path) is not None
    r2.load(path)
    assert r2.current_iteration == 2
    m_res = _run_iters(r2, 2)
    assert m_cont == m_res
    a, b = _params(r1.train_state), _params(r2.train_state)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_slim_fallback_restores_params_and_task_weight(tmp_path):
    """Without its state file a slim checkpoint restores the parameters,
    normaliser, prior, learning rate and iteration, and derives the task
    weight from the iteration (0 after the decay, 0.5 half way)."""
    log_dir = str(tmp_path / "run")
    r1 = _runner(log_dir, seed=3)
    _run_iters(r1, 1)
    path = r1.save(r1.current_iteration)
    os.remove(ckpt.sibling_state(path))
    r2 = _runner(log_dir, seed=4)
    r2.load(path)
    a, b = _params(r1.train_state), _params(r2.train_state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k in ("mean", "var", "count"):
        assert torch.equal(r1.train_state.disc_norm.state_dict()[k],
                           r2.train_state.disc_norm.state_dict()[k])
    assert torch.equal(r1.train_state.prior_parameters, r2.train_state.prior_parameters)
    assert r2.train_state.lr_ac == r1.train_state.lr_ac and r2.current_iteration == 1

    steps = r1.env.cfg.normalization.task_obs_weight_decay_steps
    for it, want in ((steps * 2, 0.0), (steps // 2, 0.5)):
        r1.current_iteration = it
        p = r1.save(it, full=False)
        r3 = _runner(log_dir, seed=5)
        r3.load(p)
        assert r3.current_iteration == it
        np.testing.assert_allclose(float(r3.train_state.task_obs_weight), want, atol=1e-6)


def test_save_cadence_and_prune(tmp_path):
    """Mid-run checkpoints carry the true iteration; the full state only at
    the full-save cadence and at the end; prune keeps the newest and the
    milestones of one prefix and extension."""
    r = _runner(str(tmp_path), num_steps_per_env=2, num_learning_epochs=1)
    r.save_interval, r.full_save_interval = 2, 4
    r.learn(5, init_at_random_ep_len=False, log_every=10)
    names = sorted(n for n in os.listdir(tmp_path) if not n.startswith("events"))
    assert names == ["model_2.msgpack", "model_4.msgpack", "model_5.msgpack",
                     "state_4.pt", "state_5.pt"]
    assert int(ckpt.read_msgpack(str(tmp_path / "model_2.msgpack"))["iteration"]) == 2
    assert ckpt.step_of("a/model_3900.msgpack") == 3900 and ckpt.step_of("a/model.msgpack") is None

    d = tmp_path / "prune"
    for step in [100, 200, 5000, 5100, 9900, 10000, 10100, 10200]:
        ckpt.save(str(d / "model.msgpack"), {"x": np.ones(1, np.float32)}, step=step)
    assert ckpt.prune(str(d), "model", keep_latest=2, keep_every=5000) == 4
    assert sorted(os.listdir(d)) == ["model_10000.msgpack", "model_10100.msgpack",
                                     "model_10200.msgpack", "model_5000.msgpack"]
    for step in (1, 2, 3):
        (d / f"state_{step}.pt").write_bytes(b"")
    ckpt.prune(str(d), "state", keep_latest=1, ext=".pt")
    assert ckpt.latest(str(d)).endswith("model_10200.msgpack")
    assert sorted(n for n in os.listdir(d) if n.startswith("state")) == ["state_3.pt"]


# ---------------------------------------------------------------------------
# the env's training side


@pytest.fixture(scope="module")
def env():
    return Go2LocomotionEnv(smoke_cfg(N), "cpu")


def test_terminal_disc_obs_is_pre_reset_state(env):
    """StepOutput.terminal_disc_obs of a reset env is the disc features of
    the post-physics, pre-reset state of that step: replaying the step with
    resets suppressed gives them as its disc_obs.  Mirrors
    tests/test_terminal_disc.py."""
    gen = torch.Generator().manual_seed(0)
    state = env.init_state()
    for _ in range(300):
        acts = torch.randn(N, 12, generator=gen) * 3.0
        prev = state
        state, out = env.step(state, acts)
        if bool(out.reset.any()):
            break
    else:
        raise AssertionError("no env terminated")
    mask = out.reset
    env2 = Go2LocomotionEnv(smoke_cfg(N), "cpu")
    env2._reset_where = lambda s, m: s
    _, out_noreset = env2.step(prev, acts)
    torch.testing.assert_close(out.terminal_disc_obs[mask], out_noreset.disc_obs[mask],
                               rtol=1e-6, atol=1e-6)
    # not the previous step's cached disc obs: the physics moved in between
    assert float((prev.disc_obs[mask] - out.terminal_disc_obs[mask]).abs().max()) > 1e-4
    assert out.terminal_disc_obs.shape == (N, 49)
    assert bool(torch.isfinite(out.terminal_disc_obs).all())


def test_expert_disc_features_match_env_features(env):
    """Expert-side disc features (mocap.disc_obs_from_frames) are computed in
    the same frames as the policy side (compute_disc_features): a frame
    vector built from a live sim state with a non-identity base orientation
    and a random twist gives the same 49 features.  Mirrors
    tests/test_env_bbc.py::test_expert_disc_features_match_env_features."""
    state = env.init_state()
    n = 4
    gen = torch.Generator().manual_seed(1)
    sim = state.sim._replace(
        base_pos=state.sim.base_pos[:n], dof_pos=state.sim.dof_pos[:n],
        base_quat=qm.quat_from_euler_xyz(torch.tensor([0.05, -0.1, 0.2, 0.0]), torch.zeros(n),
                                         torch.tensor([0.3, 1.2, -2.0, 2.9])),
        u=0.5 * torch.randn(n, 18, generator=gen))
    toe_w = soa.body_positions(env.mc, sim, env.feet_idx)           # (n, 4, 3)
    frames = torch.cat([sim.base_pos, sim.base_quat, sim.dof_pos, toe_w.reshape(n, 12),
                        sim.u[:, :3], sim.u[:, 3:6], sim.u[:, 6:18]], dim=-1)
    assert frames.shape[-1] == mocap.FRAME_DIM
    osc = env.cfg.normalization.obs_scales
    expert = mocap.disc_obs_from_frames(frames, env.mc.default_dof_pos, osc)
    policy = compute_disc_features(env.mc, env.feet_idx, osc, sim, toe_w[:, :, 2] < 0.025,
                                   sim.base_pos[:, 2:3])
    torch.testing.assert_close(expert, policy, rtol=0, atol=1e-5)
