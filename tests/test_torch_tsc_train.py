"""The port's TSC teacher trainer (learn/ppo_tsc.py, learn/runner_tsc.py,
the training half of learn/networks_tsc.py, the TSC checkpoint write side)
and the TSC env's reset path vs the JAX package, stage by stage.

The reset path: one state with a mixed mask through both packages'
_reset_where, the port fed the JAX key chain's draws (`ks = split(key, 8)`:
dx, dy, dyaw, the dof scale and lin_ang from ks[0..4], bar and tire from
ks[6], obst_idx from ks[7]); set_commands' noise from its split of the
state key.  The JAX env's own step (the SoA engine, ~150 s of XLA-CPU
compile) is never run here: states come from the port's env, carried
across field by field.

The trainer: both sides start from the JAX trainer's initial parameters
(carried across with io/checkpoint.params_from_jax_tsc), fresh optimiser
states and the frozen BBC of logs/bbc_r5/bbc_final.msgpack, and the port is
fed the JAX package's draws, re-derived here from its key chain (the
rollout's per-step split, hybrid_sample's split into the categorical's
Gumbel noise and the normals, train_iteration's split into the PPO and
DAgger permutations).  The JAX stages run jitted on XLA-CPU.

Tolerances are stated per test with the error measured on this CPU.
"""
import os
import types

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agility_tpu.envs import go2_agility as jenv
from agility_tpu.envs import tsc_config as jcfg
from agility_tpu.io import checkpoint as jckpt
from agility_tpu.learn import networks_tsc as jtnets
from agility_tpu.learn import ppo_tsc as jppo
from agility_tpu.learn import runner_tsc as jrunner
from agility_tpu.physics import engine as jeng
from agility_tpu_torch.cli import registry
from agility_tpu_torch.envs import go2_agility as tenv
from agility_tpu_torch.envs import tsc_config as tcfg
from agility_tpu_torch.io import checkpoint as tckpt
from agility_tpu_torch.learn import networks_tsc as tnets
from agility_tpu_torch.learn import ppo_tsc as tppo
from agility_tpu_torch.learn.policy_tsc import build_tsc_policy
from agility_tpu_torch.learn.runner_tsc import TscOnPolicyRunner
from agility_tpu_torch.learn.ssinfogail import priv_reg_coef
from test_gae import naive_gae
from test_torch_train import _t, metric_errors
from test_torch_train_iteration import _Replay

N = 8
KW = dict(num_steps_per_env=8, num_learning_epochs=2, num_mini_batches=2)
BBC_CKPT = os.path.join(os.path.dirname(__file__), "..", "logs", "bbc_r5", "bbc_final.msgpack")
_INT = ("episode_length", "cur_goal_idx", "spawn_goal_idx", "curr_count")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    """The JAX package's and the port's 8-env, 2-course smoke configs with
    the same dotted overrides (the port registry's apply_overrides works on
    either package's dataclasses)."""
    return (registry.apply_overrides(jcfg.tsc_smoke_cfg(N, 2), **over),
            registry.apply_overrides(tcfg.tsc_smoke_cfg(N, 2), **over))


def state_to_jax(ts, key=0):
    """The JAX AgilityState of a port AgilityState, leaf by leaf."""
    j = lambda x: jnp.asarray(x.numpy())
    fields = {k: j(getattr(ts, k)) for k in tenv.AgilityState._fields
              if k not in ("sim", "global_counter")}
    for k in _INT:
        fields[k] = fields[k].astype(jnp.int32)
    return jenv.AgilityState(sim=jeng.EnvState(*(j(x) for x in ts.sim)),
                             global_counter=jnp.asarray(ts.global_counter, jnp.int32),
                             key=jax.random.PRNGKey(key), **fields)


def jax_reset_draws(je, key):
    """The JAX _reset_where's draws from `key`, as the port's ResetDraws."""
    e = je.cfg.env
    ks = jax.random.split(key, 8)
    u = lambda k, shape, r: _t(jax.random.uniform(k, shape, minval=-r, maxval=r))
    kb, kt = jax.random.split(ks[6])
    obst = (_t(jax.random.randint(ks[7], (N,), 0, je.obst_types.shape[1])).long()
            if e.randomize_start else None)
    return tenv.ResetDraws(
        dx=u(ks[0], (N,), e.rand_x_range), dy=u(ks[1], (N,), e.rand_y_range),
        dyaw=u(ks[2], (N,), e.rand_yaw_range), obst_idx=obst,
        dof_scale=_t(jax.random.uniform(ks[3], (N, 12), minval=0.5, maxval=1.5)),
        lin_ang=u(ks[4], (N, 6), 0.5),
        bar=_t(jax.random.uniform(kb, (N,))), tire=_t(jax.random.uniform(kt, (N,))))


def assert_states_match(got, want):
    """Every AgilityState field of the port (`got`) equal to the JAX one's."""
    for k in tenv.AgilityState._fields:
        if k == "sim":
            pairs = [(f"sim.{f}", getattr(got.sim, f), getattr(want.sim, f))
                     for f in jeng.EnvState._fields]
        elif k == "global_counter":
            assert got.global_counter == int(want.global_counter)
            continue
        else:
            pairs = [(k, getattr(got, k), getattr(want, k))]
        for name, g, w in pairs:
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


RESET_CASES = {
    "start": {},
    "random_start": {"env.randomize_start": True},
    "curriculum": {"obstacle.curriculum": True},
}


@pytest.mark.parametrize("case", sorted(RESET_CASES) + ["commands"])
def test_reset_path_matches(case):
    """_reset_where on one state (the port env's after init and a step,
    carried across) with a mixed mask, both sides from the same draws: with
    randomize_start off, on, and with the obstacle curriculum at
    curr_count 18 (the bar and tire ranges widened to 0.05-0.28 and
    0.40-0.63 m); and set_commands with randomize_action on, its noise from
    the JAX state key.  Every field equal, bit for bit: no field needs a
    tolerance (base_quat through the two packages' quat_from_euler_xyz and
    the widened heights lo + (hi - lo) u were measured equal too)."""
    over = dict(RESET_CASES.get(case, {}))
    if case == "commands":
        over["domain_rand.randomize_action"] = True
    jc, tc = _cfgs(**over)
    je, te = jenv.Go2AgilityEnv(jc), tenv.Go2AgilityEnv(tc, "cpu", seed=4)
    ts = te.init_state()
    ts, _ = te.step(ts, torch.full((N, 12), 0.2))
    if case == "curriculum":
        ts = ts._replace(curr_count=torch.tensor(18))
    js = state_to_jax(ts, key=11)
    mask = np.array([True, False, True, True, False, True, False, True])
    key = jax.random.PRNGKey(7)
    if case == "commands":
        hl = np.random.default_rng(0).normal(0, 0.8, (N, 19)).astype(np.float32)
        hl[:, 0] = np.arange(N) % 3
        js2, jnc = je.set_commands(js, jnp.asarray(hl))
        _, k_noise = jax.random.split(js.key)
        noise = _t(jax.random.uniform(k_noise, (N, 5), minval=jc.domain_rand.action_noise[0],
                                      maxval=jc.domain_rand.action_noise[1]))
        ts2, tnc = te.set_commands(ts, torch.as_tensor(hl), noise)
        assert not torch.equal(noise, torch.ones_like(noise))
        np.testing.assert_array_equal(tnc.numpy(), np.asarray(jnc))
        assert_states_match(ts2, js2)
        return
    js2 = je._reset_where(js, jnp.asarray(mask), key)
    ts2 = te._reset_where(ts, torch.as_tensor(mask), jax_reset_draws(je, key))
    assert_states_match(ts2, js2)
    assert torch.equal(ts2.episode_length[torch.as_tensor(mask)], torch.zeros(5, dtype=torch.long))
    if case == "random_start":
        assert int(ts2.cur_goal_idx[torch.as_tensor(mask)].max()) > 0
    if case == "curriculum":
        assert float(ts2.bar_h[torch.as_tensor(mask)].max()) > jc.obstacle.bar_jump_init_range[1]


def test_default_reset_draws_follow_the_generator():
    """Without draws, _reset_where takes draw_reset()'s values: the same
    generator state gives the same reset either way."""
    _, tc = _cfgs(**{"env.randomize_start": True})
    te = tenv.Go2AgilityEnv(tc, "cpu", seed=2)
    s = te.init_state()
    mask = torch.arange(N) % 2 == 0
    g = te.gen.get_state()
    a = te._reset_where(s, mask)
    te.gen.set_state(g)
    b = te._reset_where(s, mask, te.draw_reset())
    for x, y in zip(jax.tree_util.tree_leaves(tuple(a)), jax.tree_util.tree_leaves(tuple(b))):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def algs():
    """(JAX trainer, port trainer) on the 8-env, 2-course smoke config with
    the frozen BBC of bbc_final.msgpack."""
    jc, tc = _cfgs()
    ja = jppo.TscPPO(jenv.Go2AgilityEnv(jc), jrunner.load_bbc_frozen(BBC_CKPT),
                     jppo.TscAlgoCfg(**KW), seed=0)
    ta = tppo.TscPPO(tenv.Go2AgilityEnv(tc, "cpu", seed=0), tckpt.load_bbc_frozen(BBC_CKPT),
                     tppo.TscAlgoCfg(**KW), seed=0)
    return ja, ta


def port_state(ta, jts):
    """A fresh port TscTrainState holding the JAX state's parameters,
    learning rate and counter."""
    ts = ta.init_train_state()
    sd = tckpt.params_from_jax_tsc({"ac_params": jts.ac_params, "est_params": jts.est_params})
    ts.ac.load_state_dict(sd["actor_critic"])
    ts.est.load_state_dict(sd["estimator"])
    ts.lr = np.float32(jts.lr)
    ts.priv_reg_counter = int(jts.priv_reg_counter)
    return ts


def _rel(g, w):
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-3))


def param_errors(ts, jts):
    """{tree: ||port - JAX|| / ||JAX||} over the actor-critic, the history
    encoder and the estimator (all tensors flattened together)."""
    got = tckpt.params_to_jax_tsc(ts.ac.state_dict(), ts.est.state_dict())
    flat = lambda t: np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(t)])
    return {"ac": _rel(flat(got["ac_params"]), flat(jts.ac_params)),
            "history_encoder": _rel(flat(got["ac_params"]["params"]["history_encoder"]),
                                    flat(jts.ac_params["params"]["history_encoder"])),
            "est": _rel(flat(got["est_params"]), flat(jts.est_params))}


def rollout_inputs(ja, jts, seed=0, T=8):
    """Transitions as the JAX rollout stores them, on random observations:
    actions sampled from the heads through the estimator swap and the
    privileged latent, values from the raw obs; random rewards and dones."""
    rng = np.random.default_rng(seed)
    s = ja.slices
    obs = jnp.asarray(rng.normal(0, 0.5, (T, N, s.total)).astype(np.float32))
    flat = obs.reshape(T * N, -1)
    est = ja.estimator.apply(jts.est_params, flat[:, :57])
    logits, mean, std = ja.ac.apply(jts.ac_params, flat.at[:, s.explicit].set(est),
                                    method="heads", hist_encoding=False)
    actions = jtnets.hybrid_sample(jax.random.PRNGKey(seed), logits, mean, std)
    logp_d, logp_c = jtnets.hybrid_log_prob(logits, mean, std, actions)
    r = lambda x: x.reshape((T, N) + x.shape[1:])
    trs = jppo.TscTransition(
        obs=obs, actions=r(actions),
        rewards=jnp.asarray(rng.normal(0, 0.1, (T, N)).astype(np.float32)),
        dones=jnp.asarray(rng.random((T, N)) < 0.1),
        values=ja.ac.apply(jts.ac_params, obs, method="value"),
        logp_d=r(logp_d), logp_c=r(logp_c), mean=r(mean),
        std=jnp.broadcast_to(std, (T, N, std.shape[0])))
    last = ja.ac.apply(jts.ac_params, obs[-1], method="value")
    adv, ret = ja.compute_gae(trs, last)
    return trs, adv, ret


def port_transition(trs):
    return tppo.TscTransition(*(_t(x) for x in trs))


def test_hybrid_helpers_match(rng):
    """hybrid_sample fed jax.random.categorical's Gumbel noise (it is
    argmax(logits + gumbel(key, logits.shape)) in the installed JAX) and
    the normals of the same key: modes and commands equal; log-probs
    measured within 2.3e-7 relative, entropies 1.2e-7; held at 1e-6."""
    M = 256
    logits = jnp.asarray(rng.normal(0, 2.0, (M, 3)).astype(np.float32))
    mean = jnp.asarray(rng.normal(0, 1.0, (M, 18)).astype(np.float32))
    std = jnp.asarray(rng.uniform(0.2, 1.5, 18).astype(np.float32))
    key = jax.random.PRNGKey(5)
    want = jtnets.hybrid_sample(key, logits, mean, std)
    kd, kc = jax.random.split(key)
    got = tnets.hybrid_sample(_t(logits), _t(mean), _t(std), _t(jax.random.gumbel(kd, (M, 3))),
                              _t(jax.random.normal(kc, (M, 18))))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want[:, 0]))
    assert len(np.unique(np.asarray(want[:, 0]))) == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for g, w in zip(tnets.hybrid_log_prob(_t(logits), _t(mean), _t(std), got),
                    jtnets.hybrid_log_prob(logits, mean, std, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for g, w in zip(tnets.hybrid_entropy(_t(logits), _t(std), mean.shape),
                    jtnets.hybrid_entropy(logits, std, mean.shape)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_networks_match_flax(algs, rng):
    """The training half of ActorCriticTSC from one flax parameter tree (the
    JAX trainer's initial one): forward (flax's __call__: logits, means,
    std, value), hist_latent and priv_latent.  float32, other summation
    orders; measured 7.7e-7 relative; held at 1e-5.  The port's own initial values
    are flax's kind: std 1, zero biases."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    obs = rng.normal(0, 1.0, (32, ja.slices.total)).astype(np.float32)
    o, t = jnp.asarray(obs), torch.as_tensor(obs)
    with torch.no_grad():
        got = ts.ac(t, t)
        for name in ("hist_latent", "priv_latent"):
            np.testing.assert_allclose(getattr(ts.ac, name)(t).numpy(),
                                       np.asarray(ja.ac.apply(jts.ac_params, o, method=name)),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    for g, w in zip(got, ja.ac.apply(jts.ac_params, o, o)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    fresh = ta.init_train_state().ac
    assert torch.equal(fresh.std.detach(), torch.ones(18))
    assert all(float(p.abs().max()) == 0 for n, p in fresh.named_parameters()
               if n.endswith("bias"))


def test_estimator_starts_from_the_bbc(algs):
    """The TSC estimator starts from the frozen BBC's, on both sides."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = ta.init_train_state()
    sd = tckpt.params_from_jax_tsc({"ac_params": jts.ac_params,
                                    "est_params": jts.est_params})["estimator"]
    for k, v in ts.est.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_disc_reward_matches(algs, rng):
    """The frozen discriminator of bbc_final.msgpack and its normaliser on
    random disc windows, and the reward mix: measured 8.4e-8 relative on
    the total; held at 1e-5."""
    ja, ta = algs
    hist = rng.normal(0, 1.0, (32, 2, 49)).astype(np.float32)
    task_r = rng.normal(0, 0.1, 32).astype(np.float32)
    want = ja.disc_reward(None, jnp.asarray(hist), jnp.asarray(task_r))
    got = ta.disc_reward(torch.as_tensor(hist), torch.as_tensor(task_r))
    assert float(want[1].std()) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_gae_matches(algs, rng):
    """compute_gae against JAX's and against tests/test_gae.py's O(T^2)
    oracle; measured 2.4e-7 (advantages) and 4.8e-7 (returns) against JAX,
    held at 1e-5, and held at the oracle test's 1e-3 / 1e-4."""
    ja, ta = algs
    T = 12
    rew = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.random((T, N)) < 0.15
    val = rng.normal(size=(T, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    z = np.zeros((T, N, 1), np.float32)
    jtrs = jppo.TscTransition(obs=z, actions=z, rewards=rew, dones=done, values=val,
                              logp_d=z[..., 0], logp_c=z[..., 0], mean=z, std=z)
    jadv, jret = ja.compute_gae(jax.tree.map(jnp.asarray, jtrs), jnp.asarray(last))
    adv, ret = ta.compute_gae(port_transition(jtrs), torch.as_tensor(last))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-5)
    want = naive_gae(rew, done.astype(np.float32), val, last, ta.cfg.gamma, ta.cfg.lam)
    np.testing.assert_allclose(adv.numpy(), (want - want.mean()) / (want.std() + 1e-8),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("counter", [0, 1200])
def test_ppo_update_matches(algs, counter):
    """ppo_update from the same parameters, fresh Adam states and JAX's
    permutation, with the priv-reg coefficient 0 (counter 0) and 0.07
    (counter 1200): the metrics, the adaptive learning rate, the counter,
    the actor-critic, its history encoder (untouched by PPO) and the
    estimator afterwards, with the min-std clamp acting (std starts at
    0.1).  Measured: metrics 1.1e-5 relative (either counter), parameters
    2.7e-6 (actor-critic), 1.8e-8 (estimator) and 0 (history encoder), as
    the norm of the difference over the norm, std 3.0e-8; held at 1e-4,
    1e-5 and 1e-6."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ac = jax.tree.map(lambda x: x, jts.ac_params)
    ac["params"]["std"] = jnp.full((18,), 0.1, jnp.float32).at[:6].set(0.5)
    jts = jts._replace(ac_params=ac, priv_reg_counter=jnp.asarray(counter, jnp.int32))
    ts = port_state(ta, jts)
    trs, adv, ret = rollout_inputs(ja, jts)
    key = jax.random.PRNGKey(7)
    jts2, jm = jax.jit(ja.ppo_update)(jts, trs, adv, ret, key)
    perm = _t(jax.random.permutation(key, trs.rewards.size)).long()
    tm = ta.ppo_update(ts, port_transition(trs), _t(adv), _t(ret), perm)
    merr, perr = metric_errors(tm, jm), param_errors(ts, jts2)
    assert float(ts.lr) == float(jts2.lr) != float(jts.lr)
    assert ts.priv_reg_counter == int(jts2.priv_reg_counter) == counter + 1
    assert float(jm["ppo/priv_reg"]) > 0
    assert (priv_reg_coef(ta.cfg.priv_reg_coef_schedule, counter) > 0) == (counter > 500)
    assert max(merr.values()) < 1e-4, merr
    assert max(perr.values()) < 1e-5, perr
    np.testing.assert_allclose(ts.ac.std.detach().numpy(),
                               np.asarray(jts2.ac_params["params"]["std"]), rtol=1e-6)
    assert float(ts.ac.std.min()) == np.float32(0.15)


def test_dagger_update_matches(algs):
    """dagger_update from the same parameters and JAX's permutation: the
    history encoder afterwards, the rest unchanged, and the counter.
    Measured 3.5e-8 on the history encoder's parameters and 0 on the loss;
    held at 1e-5 and 1e-4."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    trs, _, _ = rollout_inputs(ja, jts, seed=1)
    key = jax.random.PRNGKey(11)
    jts2, jl = jax.jit(ja.dagger_update)(jts, trs, key)
    perm = _t(jax.random.permutation(key, trs.rewards.size)).long()
    before = {k: v.clone() for k, v in ts.ac.state_dict().items()}
    tl = ta.dagger_update(ts, port_transition(trs), perm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    perr = param_errors(ts, jts2)
    assert max(perr.values()) < 1e-5, perr
    changed = {k for k, v in ts.ac.state_dict().items() if not torch.equal(v, before[k])}
    assert changed and all(k.startswith("history_encoder.") for k in changed)
    assert ts.priv_reg_counter == int(jts2.priv_reg_counter) == 1


def test_rollout_over_resets_matches(algs, monkeypatch):
    """The rollout's bookkeeping where envs reset, port vs JAX, both driven
    by the same recorded env outputs (eight steps of the port's env with
    zero actions) with set_commands real on each side: four envs time out
    (at steps 0, 2, 5 and 7), one finishes the course at step 0, three run
    on.  Checked: the stored raw obs, the actions (Gumbel modes, normals),
    both log-probs, means, values, the rewards with the time-out bootstrap,
    the disc window patched with terminal_disc_obs and restarted, dones and
    the metrics.  The env data is shared, so only the networks' float32
    summation orders differ: measured 5.8e-7 on actions, 5.4e-7 on means,
    3.0e-7 on values, 2.4e-7 on log-probs, 1.0e-7 on rewards and 4.2e-9 on
    the metrics (relative, floored at 1); held at 1e-5 relative + 1e-5
    absolute.  Modes and the disc window are equal."""
    ja, ta = algs
    T = ja.cfg.num_steps_per_env
    te = ta.env
    es0 = te.init_state()
    L = te.max_episode_length
    lag = np.array([0, 2, 5, 7, 100, 150, 200, 250])
    last = te.n_goals_total - te.last_goal_repeat - 1
    es0 = es0._replace(
        episode_length=torch.as_tensor(L - lag),
        cur_goal_idx=torch.where(torch.arange(N) == 5, last, es0.cur_goal_idx),
        reach_goal_timer=torch.where(torch.arange(N) == 5, 1e3, es0.reach_goal_timer))
    states, outs, s = [], [], es0
    for _ in range(T):
        s, out = te.step(s, torch.zeros(N, 12))
        states.append(s)
        outs.append(out)
    finish = torch.stack([o.reach_goal_cutoff for o in outs])
    time_out = torch.stack([o.time_out for o in outs])
    assert bool(finish[0, 5]) and bool(time_out[0, 5])
    for e, k in enumerate(lag[:4]):
        assert bool(time_out[k, e])

    g0 = es0.global_counter
    jstates = [state_to_jax(x) for x in states]
    jouts = [jenv.TscStepOutput(*(jnp.asarray(getattr(o, f).numpy())
                                  for f in jenv.TscStepOutput._fields)) for o in outs]
    stacked = (jax.tree.map(lambda *x: jnp.stack(x), *jstates),
               jax.tree.map(lambda *x: jnp.stack(x), *jouts))
    monkeypatch.setattr(ja, "env", _Replay(ja.env, g0, lambda t: jax.tree.map(
        lambda x: x[t], stacked)))
    monkeypatch.setattr(ta, "env", _Replay(te, g0, lambda t: (states[t], outs[t])))

    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    jes0 = state_to_jax(es0)
    dh = jnp.repeat(jes0.disc_obs[:, None], 2, axis=1)
    key, gumbel, normal = jts.key, [], []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        kd, kc = jax.random.split(k_act)
        gumbel.append(jax.random.gumbel(kd, (N, 3)))
        normal.append(jax.random.normal(kc, (N, 18)))
    jts2, _, jdh, jtrs, jm = jax.jit(ja.rollout)(jts, jes0, dh, jnp.asarray(True))
    _, tdh, trs, tm = ta.rollout(ts, es0, _t(dh), True, _t(jnp.stack(gumbel)),
                                 _t(jnp.stack(normal)))

    np.testing.assert_array_equal(trs.dones.numpy(), np.asarray(jtrs.dones))
    assert int(trs.dones.sum()) >= 5
    np.testing.assert_array_equal(trs.obs.numpy(), np.asarray(jtrs.obs))
    np.testing.assert_array_equal(trs.actions[..., 0].numpy(), np.asarray(jtrs.actions[..., 0]))
    tol = dict(rtol=1e-5, atol=1e-5)
    for k in ("actions", "mean", "std", "values", "logp_d", "logp_c", "rewards"):
        np.testing.assert_allclose(getattr(trs, k).numpy(), np.asarray(getattr(jtrs, k)),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(tdh.numpy(), np.asarray(jdh))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **tol)
    assert float(tm["success"]) == 1.0
    # the bootstrap: a time-out's reward carries gamma x its pre-step value
    t0, e0 = int(lag[1]), 1
    r_no = ta.disc_reward(torch.stack([states[t0 - 1].disc_obs[e0], outs[t0].terminal_disc_obs[e0]])
                          [None], outs[t0].rew[e0:e0 + 1])[0]
    np.testing.assert_allclose(float(trs.rewards[t0, e0]),
                               float(r_no) + ta.cfg.gamma * float(trs.values[t0, e0]), rtol=1e-5)


def test_slim_checkpoint_reads_back(algs, tmp_path):
    """A port runner's slim TSC checkpoint is read by the JAX package's
    checkpoint.load_into into a template in the JAX runner's
    checkpoint_tree layout, built from the flax modules' own init, every
    leaf equal; by play_tsc's loader to equal tensors; and its bytes are
    flax's own encoding of the same tree."""
    ja, ta = algs
    r = TscOnPolicyRunner(ta.env, tckpt.load_bbc_frozen(BBC_CKPT), ta.cfg,
                          log_dir=str(tmp_path), seed=2)
    r.current_iteration = 7
    r.train_state.lr = np.float32(0.00123)
    path = r.save(7, full=False)
    assert os.path.basename(path) == "model_7.msgpack" and tckpt.sibling_state(path) is None
    obs0 = jnp.zeros((1, ja.slices.total))
    template = jrunner.TscOnPolicyRunner.checkpoint_tree(types.SimpleNamespace(
        train_state=types.SimpleNamespace(
            ac_params=ja.ac.init(jax.random.PRNGKey(0), obs0, obs0),
            est_params=ja.estimator.init(jax.random.PRNGKey(1), jnp.zeros((1, 57))),
            lr=jnp.asarray(5e-4, jnp.float32)),
        current_iteration=0))
    restored = jckpt.load_into(path, jax.device_get(template))
    mine = r.checkpoint_tree()
    flat_r = jax.tree_util.tree_flatten_with_path(restored)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(jax.device_get(template))[0]
    flat_m = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    assert [p for p, _ in flat_r] == [p for p, _ in flat_t] == list(flat_m)
    for (p, a), (_, t) in zip(flat_r, flat_t):
        assert np.shape(a) == np.shape(t) and np.asarray(a).dtype == np.asarray(t).dtype, p
        np.testing.assert_array_equal(np.asarray(a), flat_m[p], err_msg=str(p))
    assert int(restored["iteration"]) == 7
    sd = tckpt.params_from_jax_tsc(tckpt.read_msgpack(path))
    pol = build_tsc_policy(ta.env.cfg, sd, device="cpu")
    for mod, back in ((r.train_state.ac, pol.ac), (r.train_state.est, pol.est)):
        for (k, a), b in zip(mod.state_dict().items(), back.state_dict().values()):
            assert torch.equal(a, b), k
    with open(path, "rb") as f:
        assert f.read() == ser.to_bytes(mine)
