"""The port's BBC env and mocap module vs agility_tpu.envs.

One env step from an identical state and identical actions (and one with
sim.solver="soft", on the per-env engine): the JAX env's
state is carried across with `state_from_jax`, noise, pushes and action
delay are off, and the compared step has no reset and no command resample
(the two packages draw from different random streams).  The JAX step runs
the SoA engine (AGILITY_ENGINE=soa; tests/conftest.py selects the vmapped
oracle, under which a warm-start config becomes 10 cold sweeps), eagerly
(jax.disable_jit) since its SoA HLO takes minutes to compile on XLA-CPU.

Tolerances: states match to the SoA step's 1e-5 / 1e-3 (u); observations
are affine in the state (scales <= 1) and rewards are smooth in it except
for the contact/collision thresholds, which this step does not straddle.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.envs import go2_locomotion as jenv
from agility_tpu.envs import mocap as jmocap
from agility_tpu.envs import config as jcfg
from agility_tpu_torch.envs import config as tcfg
from agility_tpu_torch.envs import go2_locomotion as tenv
from agility_tpu_torch.envs import mocap as tmocap
from agility_tpu_torch.physics import heightfield as thf

N = 4


def _cfg(m):
    """The test's config from config module `m` (the JAX package's or the port's)."""
    return m.Go2LocomotionCfg(
        env=m.EnvCfg(num_envs=N),
        domain_rand=m.DomainRandCfg(push_robots=False, action_delay=False),
        noise=m.NoiseCfg(add_noise=False))


CFG, TCFG = _cfg(jcfg), _cfg(tcfg)


@pytest.fixture(scope="module")
def envs():
    return jenv.Go2LocomotionEnv(CFG), tenv.Go2LocomotionEnv(TCFG, "cpu")


@pytest.fixture(scope="module")
def step_pair(envs):
    """(JAX state, JAX step output, port state, port step output) for one
    step from the JAX env's initial state."""
    je, te = envs
    # conftest's vmap engine compiles fast enough to jit the initial state
    s0 = jax.jit(je.init_state)(jax.random.PRNGKey(3))
    acts = np.random.default_rng(0).normal(0, 0.5, (N, 12)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setenv("AGILITY_ENGINE", "soa")
    try:
        with jax.disable_jit():
            s1, out = je.step(s0, jnp.asarray(acts))
    finally:
        mp.undo()
    t1, tout = te.step(tenv.state_from_jax(s0, "cpu"), torch.as_tensor(acts))
    return s1, out, t1, tout


def test_domain_randomization_matches(envs):
    je, te = envs
    for f in ("friction", "kp_scale", "kd_scale", "added_base_mass", "base_com_shift"):
        np.testing.assert_array_equal(getattr(te.params, f).numpy(),
                                      np.asarray(getattr(je.params, f)), err_msg=f)
    np.testing.assert_array_equal(te.env_origins.numpy(), np.asarray(je.env_origins))
    np.testing.assert_array_equal(te.grid.height.numpy(), np.asarray(je.grid.height))
    assert te.reward_names == je.reward_names


def test_env_step_matches(step_pair):
    s1, out, t1, tout = step_pair
    assert not bool(out.reset.any()) and not bool(tout.reset.any())
    assert int(np.asarray(s1.episode_length).max()) < 300    # no command resample
    for k, atol in dict(base_pos=1e-5, base_quat=1e-5, dof_pos=1e-5, u=1e-3).items():
        np.testing.assert_allclose(getattr(t1.sim, k).numpy(), np.asarray(getattr(s1.sim, k)),
                                   atol=atol, err_msg=k)
    for k in ("obs", "privileged_obs", "disc_obs", "terminal_disc_obs"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(out, k)),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tout.reward_terms.numpy(), np.asarray(out.reward_terms),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tout.rew.numpy(), np.asarray(out.rew), rtol=1e-4, atol=1e-6)
    for k in ("contact_filt", "last_contacts", "episode_length", "commands", "latent_c"):
        np.testing.assert_array_equal(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                      err_msg=k)
    for k in ("obs_history", "torques_org", "last_actions", "last_dof_vel"):
        np.testing.assert_allclose(getattr(t1, k).numpy(), np.asarray(getattr(s1, k)),
                                   atol=1e-3, err_msg=k)
    assert t1.global_counter == int(s1.global_counter)


def test_masked_reset_statistics(envs):
    """The port's masked reset: fresh unit-quaternion poses above the
    terrain where the mask is set, nothing touched elsewhere."""
    _, te = envs
    s = te.init_state()
    s = s._replace(episode_length=torch.full((N,), 37),
                   actions=torch.ones(N, 12), obs_history=torch.ones_like(s.obs_history))
    mask = torch.tensor([True, False, True, False])
    r = te._reset_where(s, mask)
    q = r.sim.base_quat
    torch.testing.assert_close(torch.linalg.vector_norm(q, dim=-1), torch.ones(N))
    p = r.sim.base_pos
    ground = thf.sample_height(te.grid, p[:, 0], p[:, 1])
    assert bool((p[mask, 2] - ground[mask] > 0.2).all())      # mocap root height ~0.3 m
    assert r.episode_length.tolist() == [0, 37, 0, 37]
    assert bool((r.actions[mask] == 0).all()) and bool((r.actions[~mask] == 1).all())
    assert bool((r.obs_history[mask] == 0).all())
    for a, b in zip(r.sim, s.sim):
        torch.testing.assert_close(a[~mask], b[~mask], rtol=0, atol=0)
    # the reset envs' joints come from the trot/walk/... clips, not the old state
    assert not torch.equal(r.sim.dof_pos[mask], s.sim.dof_pos[mask])


def test_synthetic_mocap_matches(envs):
    je, te = envs
    jm, tm = je.motion, te.motion
    np.testing.assert_allclose(tm.frames.numpy(), np.asarray(jm.frames), atol=1e-5)
    np.testing.assert_array_equal(tm.clip_start.numpy(), jm.clip_start)
    np.testing.assert_array_equal(tm.clip_len.numpy(), jm.clip_len)
    np.testing.assert_array_equal(tm.cat_logits.numpy(), jm._cat_logits())
    # the time interpolation at drawn (clip, t) pairs
    rng = np.random.default_rng(1)
    clip = rng.integers(0, len(jm.clip_start), 16)
    t = (rng.uniform(0, 1, 16) * jm.clip_len[clip]).astype(np.float32)
    np.testing.assert_allclose(
        tm.frames_at(torch.as_tensor(clip), torch.as_tensor(t)).numpy(),
        np.asarray(jm._frames_at(jnp.asarray(clip), jnp.asarray(t))), atol=1e-5)
    np.testing.assert_allclose(
        tmocap.disc_obs_from_frames(tm.frames, te.mc.default_dof_pos,
                                    TCFG.normalization.obs_scales).numpy(),
        np.asarray(jmocap.disc_obs_from_frames(jm.frames, je.mc.default_dof_pos,
                                               CFG.normalization.obs_scales)),
        atol=1e-5)


def test_sample_frames_statistics(envs):
    _, te = envs
    c_idx = torch.arange(200) % 5
    f = te.motion.sample_frames(te.gen, c_idx, te.dt)
    assert f.shape == (200, tmocap.FRAME_DIM) and bool(torch.isfinite(f).all())
    torch.testing.assert_close(torch.linalg.vector_norm(f[:, tmocap.ROOT_ROT], dim=-1),
                               torch.ones(200))
    # each env's frame comes from a clip of its own mode: forward speed
    # follows the per-mode gait speeds (walk 0.4 ... canter 1.6 m/s)
    vx = f[:, tmocap.LIN_VEL][:, 0]
    means = [float(vx[c_idx == c].mean()) for c in range(5)]
    assert means[0] < 0.7 and means[3] > 1.1, means


def test_env_soft_solver_matches_jax():
    """One env step with sim.solver="soft" (penalty contacts on the per-env
    engine) from one state and one action batch, against the JAX env's step
    (jitted; with this solver it takes its per-env engine whatever
    AGILITY_ENGINE says), at tests/test_soa.py's tolerances.  The port's
    envs once dropped `solver` and ran the SoA Jacobi solve instead
    (ROADMAP Queue 3); the errors print with -s."""
    cfg = lambda m: m.Go2LocomotionCfg(
        env=m.EnvCfg(num_envs=N), sim=m.SimCfg(solver="soft"),
        domain_rand=m.DomainRandCfg(push_robots=False, action_delay=False),
        noise=m.NoiseCfg(add_noise=False))
    je, te = jenv.Go2LocomotionEnv(cfg(jcfg)), tenv.Go2LocomotionEnv(cfg(tcfg), "cpu")
    s0 = jax.jit(je.init_state)(jax.random.PRNGKey(3))
    acts = np.random.default_rng(0).normal(0, 0.5, (N, 12)).astype(np.float32)
    s1, _ = jax.jit(je.step)(s0, jnp.asarray(acts))
    t1, _ = te.step(tenv.state_from_jax(s0, "cpu"), torch.as_tensor(acts))
    tol = dict(base_pos=5e-4, base_quat=5e-4, dof_pos=1e-3, u=3e-2)
    errs = {k: float(np.abs(getattr(t1.sim, k).numpy() - np.asarray(getattr(s1.sim, k))).max())
            for k in tol}
    print("soft env step, port vs JAX, max abs error:", errs)
    assert all(errs[k] <= tol[k] for k in tol), errs
    assert te.engine_cfg.solver == "soft"
