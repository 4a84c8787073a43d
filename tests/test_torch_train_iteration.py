"""One whole BBC train_iteration of the port vs the JAX package's, from
the same initial states and parameters, every draw injected (the stages
one by one: tests/test_torch_train.py, whose fixture and helpers this
file shares)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from agility_tpu_torch.envs import go2_locomotion as tenv
from agility_tpu_torch.learn import ssinfogail as tgail
from test_torch_train import (N, _t, algs, disc_draws, metric_errors, one_thread,  # noqa: F401
                              param_errors, port_state)


def test_train_iteration_matches(algs):
    """One whole iteration (it = 0: rollout, GAE, PPO, disc, DAgger, task
    weight decay) from the JAX initial states, every draw injected.  Noise,
    pushes and randomisation are off in smoke_cfg and no env resets within
    T = 8 (asserted from JAX's dones), so no env draw reaches the state.  The JAX
    rollout steps the vmapped engine, the port the SoA one (1e-5 apart a
    substep; the dof-acceleration and torque terms of the task reward
    magnify the difference): measured 2.6e-2 on rollout/r_t (|port - JAX|
    over max(|JAX|, 1e-3)), at most 5.2e-3 on the other metrics, parameters 1.5e-3
    (actor-critic) and 9.8e-3 (discriminator, fed those rollouts); held at
    5e-2 and 2e-2."""
    ja, ta = algs
    es = jax.jit(ja.env.init_state)(jax.random.PRNGKey(3))
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    dh = jnp.repeat(es.disc_obs[:, None], ja.disc_obs_len, axis=1)
    ts = port_state(ta, jts)

    T, A = ja.cfg.num_steps_per_env, 12
    key, noise = jts.key, []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (N, A)))
    k1, k2, k3, _ = jax.random.split(key, 4)
    draws = tgail.Draws(
        action_noise=_t(jnp.stack(noise)),
        ppo_perm=_t(jax.random.permutation(k1, T * N)).long(),
        disc_idx=disc_draws(ja, k2, T * N),
        dagger_perm=_t(jax.random.permutation(k3, T * N)).long())

    jts2, jes2, jdh2, jm = jax.jit(ja.train_iteration)(jts, es, dh, jnp.asarray(0))
    ts, tes2, tdh2, tm = ta.train_iteration(ts, tenv.state_from_jax(es, "cpu"), _t(dh), 0, draws)
    assert not bool(np.asarray(jes2.reset_buf).any()) and float(jm["rollout/ep_done"]) == 0
    merr, perr = metric_errors(tm, jm), param_errors(ts, jts2)
    assert max(merr.values()) < 5e-2, merr
    assert max(perr.values()) < 2e-2, perr
    # the vmapped and SoA engines, eight control steps apart (5e-4 after one
    # in tests/test_soa.py): measured 5.5e-4
    np.testing.assert_allclose(tes2.sim.base_pos.numpy(), np.asarray(jes2.sim.base_pos),
                               atol=2e-3)
    # the disc features (joint velocities among them) part further where a
    # foot touches down a substep apart: measured 0.18 in two of the eight
    # envs (dof_vel x 0.05), under 6e-3 in the others
    np.testing.assert_allclose(tdh2.numpy(), np.asarray(jdh2), atol=0.25)
    assert ts.ring.size == int(jts2.ring.size) == T * N
    np.testing.assert_allclose(ts.ring.data[:T * N].numpy(), np.asarray(jts2.ring.data[:T * N]),
                               atol=0.25)
    assert float(ts.task_obs_weight) == float(jts2.task_obs_weight)
    assert (ts.learning_steps, ts.priv_reg_counter) == (1, 2) == (
        int(jts2.learning_steps), int(jts2.priv_reg_counter))
    assert float(ts.lr_ac) == float(jts2.lr_ac)


class _Replay:
    """An env whose step hands back recorded outputs, the t-th for a state
    t control steps past the first (by its global counter), whatever the
    actions; everything else is the wrapped env's."""

    def __init__(self, env, g0, step):
        self._env, self._g0, self._step = env, g0, step

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, es, actions, grid=None):
        return self._step(es.global_counter - self._g0)


def test_rollout_over_resets_matches(algs, monkeypatch):
    """The rollout's bookkeeping where envs reset, port vs JAX, both driven
    by the same recorded env outputs: eight steps of the JAX env (zero
    actions) from a state where five envs time out, at steps 0, 1, 3, 5
    and 7, and three do not.  Checked: the time-out bootstrap in the
    rewards, the disc window patched with terminal_disc_obs and restarted
    after the insert, the ring rows carrying the post-reset latent_eps and
    latent_c, dones and the metrics.  The env is the same data on both
    sides, so only the networks' float32 summation orders differ: measured
    4.8e-7 on actions, 2.7e-7 on values, 1.5e-7 on rewards, 3.8e-6 on
    log-probs near -20 and 3.7e-9 on the metrics; held at 1e-5 relative +
    1e-5 absolute.  The disc window and the ring rows are copies of env
    outputs: equal."""
    ja, ta = algs
    T, A = ja.cfg.num_steps_per_env, 12
    es0 = jax.jit(ja.env.init_state)(jax.random.PRNGKey(5))
    L = ja.env.max_episode_length
    lag = np.array([0, 1, 3, 5, 7, 100, 150, 200])       # steps to the time-out
    es0 = es0._replace(episode_length=jnp.asarray(L - lag, jnp.int32))
    jstep = jax.jit(ja.env.step)
    es, states, outs = es0, [], []
    for _ in range(T):
        es, out = jstep(es, jnp.zeros((N, A)))
        states.append(es)
        outs.append(out)
    time_out = np.stack([np.asarray(o.time_out) for o in outs])
    np.testing.assert_array_equal(time_out.any(0), lag < T)
    np.testing.assert_array_equal(np.argmax(time_out[:, lag < T], 0), lag[lag < T])

    g0 = int(es0.global_counter)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states), jax.tree.map(
        lambda *x: jnp.stack(x), *outs)
    monkeypatch.setattr(ja, "env", _Replay(
        ja.env, g0, lambda t: jax.tree.map(lambda x: x[t], stacked)))
    port = [(tenv.state_from_jax(s, "cpu"),
             tenv.StepOutput(*(_t(getattr(o, f)) for f in tenv.StepOutput._fields)))
            for s, o in zip(states, outs)]
    monkeypatch.setattr(ta, "env", _Replay(ta.env, g0, lambda t: port[t]))

    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    dh = jnp.repeat(es0.disc_obs[:, None], ja.disc_obs_len, axis=1)
    key, noise = jts.key, []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (N, A)))
    jts2, _, jdh, jtrs, jm = jax.jit(ja.rollout)(jts, es0, dh, jnp.asarray(True))
    _, tdh, trs, tm = ta.rollout(ts, tenv.state_from_jax(es0, "cpu"), _t(dh), True,
                                 _t(jnp.stack(noise)))

    np.testing.assert_array_equal(trs.dones.numpy(), np.asarray(jtrs.dones))
    assert int(np.asarray(jtrs.dones).sum()) >= int((lag < T).sum())
    np.testing.assert_array_equal(trs.obs.numpy(), np.asarray(jtrs.obs))
    tol = dict(rtol=1e-5, atol=1e-5)
    for k in ("actions", "mean", "values", "log_prob", "rewards"):
        np.testing.assert_allclose(getattr(trs, k).numpy(), np.asarray(getattr(jtrs, k)),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(tdh.numpy(), np.asarray(jdh))
    assert (ts.ring.size, ts.ring.cursor) == (int(jts2.ring.size), int(jts2.ring.cursor)) == (
        T * N, T * N)
    np.testing.assert_array_equal(ts.ring.data[:T * N].numpy(),
                                  np.asarray(jts2.ring.data[:T * N]))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **tol)
    # the rows of a reset step hold the new episode's latents, not the old
    rows = ts.ring.data[:T * N].reshape(T, N, -1)
    t0, n0 = int(lag[1]), 1
    new = torch.cat([port[t0][0].latent_eps[n0], port[t0][0].latent_c[n0]])
    assert torch.equal(rows[t0, n0, -new.shape[0]:], new)
    assert not torch.equal(new, torch.cat([port[t0 - 1][0].latent_eps[n0],
                                           port[t0 - 1][0].latent_c[n0]]))
