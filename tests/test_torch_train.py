"""The port's BBC trainer (learn/ssinfogail.py, learn/replay.py, the
training half of learn/networks.py and envs/mocap.py, the checkpoint write
side) vs the JAX package, stage by stage (the whole iteration:
tests/test_torch_train_iteration.py).

Both sides start from the same parameters (the JAX trainer's initial ones,
carried across with io/checkpoint.params_from_jax), the same fresh
optimiser state and the same expert tables, and the port is fed the JAX
package's random draws, re-derived here from its key chain
(`train_iteration` :661-681, `disc_update` :552-558, the rollout's
per-step split :273).  The JAX side runs jitted on XLA-CPU (the small
shapes compile in seconds; eagerly the 8-step rollout alone takes minutes)
with tests/conftest.py's vmapped engine.

Tolerances are stated per test with the error measured on this CPU.
"""
import os
import types

import numpy as np
import flax.serialization as ser
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.envs import config as jcfg
from agility_tpu.envs import go2_locomotion as jenv
from agility_tpu.io import checkpoint as jckpt
from agility_tpu.learn import networks as jnets
from agility_tpu.learn import replay as jreplay
from agility_tpu.learn import runner as jrunner
from agility_tpu.learn import ssinfogail as jgail
from agility_tpu_torch.envs import config as tcfg
from agility_tpu_torch.envs import go2_locomotion as tenv
from agility_tpu_torch.io import checkpoint as tckpt
from agility_tpu_torch.learn import networks as tnets
from agility_tpu_torch.learn import replay as treplay
from agility_tpu_torch.learn import runner as trunner
from agility_tpu_torch.learn import ssinfogail as tgail
from test_gae import naive_gae

N = 8
KW = dict(num_steps_per_env=8, num_preload_transitions=256, disc_replay_buffer_size=512,
          num_learning_epochs=2, num_mini_batches=2)
CKPT = os.path.join(os.path.dirname(__file__), "..", "logs", "bbc_r5", "bbc_15k.msgpack")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def algs():
    """(JAX trainer, port trainer) on the 8-env smoke config, the port's
    expert tables set to the JAX trainer's."""
    ja = jgail.SSInfoGAIL(jenv.Go2LocomotionEnv(jcfg.smoke_cfg(N)), jgail.AlgoCfg(**KW), seed=0)
    ta = tgail.SSInfoGAIL(tenv.Go2LocomotionEnv(tcfg.smoke_cfg(N), "cpu"),
                          tgail.AlgoCfg(**KW), seed=0)
    ta.expert_lb = torch.as_tensor(np.asarray(ja.expert_lb))
    ta.expert_labels = torch.as_tensor(np.asarray(ja.expert_labels)).long()
    ta.expert_ulb = torch.as_tensor(np.asarray(ja.expert_ulb))
    return ja, ta


def _t(x):
    return torch.as_tensor(np.array(x))


def port_state(ta, jts):
    """A fresh port TrainState holding the JAX TrainState's parameters,
    normaliser, ring, prior, learning rate, task weight and counters."""
    ts = ta.init_train_state()
    sd = tckpt.params_from_jax({"ac_params": jts.ac_params, "est_params": jts.est_params,
                                "disc_params": jts.disc_params})
    ts.ac.load_state_dict(sd["actor_critic"])
    ts.est.load_state_dict(sd["estimator"])
    ts.disc.load_state_dict(sd["discriminator"])
    ts.disc_norm.load_state_dict(jts.disc_norm)
    ts.ring.data.copy_(_t(jts.ring.data))
    ts.ring.cursor, ts.ring.size = int(jts.ring.cursor), int(jts.ring.size)
    ts.prior_parameters = _t(jts.prior_parameters)
    ts.lr_ac = np.float32(jts.lr_ac)
    ts.task_obs_weight = np.float32(jts.task_obs_weight)
    ts.learning_steps, ts.priv_reg_counter = int(jts.learning_steps), int(jts.priv_reg_counter)
    return ts


def param_errors(ts, jts):
    """{network: ||port - JAX|| / ||JAX||} over each network's parameters,
    all its tensors flattened together (two-norms).  A ReLU unit whose
    pre-activation lies within rounding of zero on some row sends the two
    sides' gradients apart there, so single elements can differ by up to
    a learning-rate step; the norm over the network holds the rest."""
    got = tckpt.params_to_jax(ts.ac.state_dict(), ts.est.state_dict(), ts.disc.state_dict())
    out = {}
    for k in ("ac_params", "est_params", "disc_params"):
        g = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(got[k])])
        w = np.concatenate([np.ravel(np.asarray(x))
                            for x in jax.tree_util.tree_leaves(getattr(jts, k))])
        out[k] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return out


def metric_errors(tm, jm):
    assert set(tm) == set(jm)
    return {k: abs(float(tm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-3) for k in jm}


def rollout_inputs(ja, jts, seed=0, T=8):
    """Transitions as the JAX rollout stores them, on random observations:
    the acting mean through the estimator swap and the DAgger switch (off),
    values from the critic, log-probs of noisy actions; random rewards and
    dones.  Returns the JAX Transition and its GAE."""
    rng = np.random.default_rng(seed)
    s = ja.slices
    obs = jnp.asarray(rng.normal(0, 0.5, (T, N, s.total)).astype(np.float32))
    flat = obs.reshape(T * N, -1)
    est = ja.estimator.apply(jts.est_params, flat[:, s.prop])
    mean = ja.ac.apply(jts.ac_params, flat.at[:, s.explicit].set(est), False,
                       method="action_mean_switch").reshape(T, N, -1)
    std = jts.ac_params["params"]["std"]
    actions = mean + std * jnp.asarray(rng.normal(size=mean.shape).astype(np.float32))
    trs = jgail.Transition(
        obs=obs, critic_obs=obs, actions=actions,
        rewards=jnp.asarray(rng.normal(0, 0.1, (T, N)).astype(np.float32)),
        dones=jnp.asarray(rng.random((T, N)) < 0.1),
        values=ja.ac.apply(jts.ac_params, obs, method="value"),
        log_prob=jnets.gaussian_log_prob(mean, std, actions), mean=mean,
        std=jnp.broadcast_to(std, mean.shape))
    last = ja.ac.apply(jts.ac_params, obs[-1], method="value")
    adv, ret = ja.compute_gae(trs, last)
    return trs, adv, ret


def port_transition(trs):
    return tgail.Transition(*(_t(x) for x in trs))


def disc_draws(ja, key, ring_size):
    """disc_update's draws from `key` (:552-558), as the port's (n_mb, 3, mb)."""
    n_mb = ja.cfg.num_learning_epochs * ja.cfg.num_mini_batches * 4
    mb = max(1, ja.cfg.num_steps_per_env * N // n_mb)
    rows = []
    for k in jax.random.split(key, n_mb):
        k1, k2, k3 = jax.random.split(k, 3)
        rows.append([jax.random.randint(k1, (mb,), 0, max(ring_size, 1)),
                     jax.random.randint(k2, (mb,), 0, ja.expert_lb.shape[0]),
                     jax.random.randint(k3, (mb,), 0, ja.expert_ulb.shape[0])])
    return torch.as_tensor(np.asarray(rows)).long()


# ---------------------------------------------------------------------------


def test_discriminator_and_disc_reward_match_flax(algs, rng):
    """The trained discriminator of bbc_15k (and its normaliser) on random
    features, and disc_reward on random windows and labels.  float32,
    different summation orders through three layers; measured 6.3e-7
    (logit), 1.7e-6 (classifier), 3.5e-6 (total reward); held at 1e-5."""
    ja, ta = algs
    with open(CKPT, "rb") as f:
        ref = ser.msgpack_restore(f.read())
    disc = tnets.Discriminator(98)
    disc.load_state_dict(tckpt.params_from_jax(tckpt.read_msgpack(CKPT))["discriminator"])
    x = rng.normal(0, 1.0, (32, 98)).astype(np.float32)
    want = jnets.Discriminator(dim_c=5).apply(ref["disc_params"], jnp.asarray(x))
    with torch.no_grad():
        got = disc(torch.as_tensor(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    jts = ja.init_train_state(jax.random.PRNGKey(1))._replace(
        disc_params=ref["disc_params"],
        disc_norm={k: jnp.asarray(v) for k, v in ref["disc_norm"].items()})
    ts = port_state(ta, jts)
    ts.task_obs_weight = np.float32(0.7)
    obs = rng.normal(0, 1.0, (32, ja.slices.total)).astype(np.float32)
    hist = rng.normal(0, 1.0, (32, 2, 49)).astype(np.float32)
    task_r = rng.normal(0, 0.1, 32).astype(np.float32)
    want = ja.disc_reward(jts.disc_params, jts.disc_norm, jnp.asarray(obs), jnp.asarray(hist),
                          jnp.asarray(task_r), jnp.float32(0.7))
    with torch.no_grad():
        got = ta.disc_reward(ts, torch.as_tensor(obs), torch.as_tensor(hist),
                             torch.as_tensor(task_r))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_running_normalizer_matches(rng):
    """Two Welford merges (population variance, count from 1e-4) and the
    clipped normalisation; float32, measured 1.2e-7 relative on the
    statistics and 9.5e-7 on outputs up to 10; held at 1e-6 (+ 1e-6
    absolute on the outputs)."""
    a = rng.normal(2.0, 3.0, (64, 7)).astype(np.float32)
    b = rng.normal(-1.0, 0.5, (9, 7)).astype(np.float32)
    x = rng.normal(0.0, 40.0, (16, 7)).astype(np.float32)
    js = jnets.RunningNormalizer.init(7)
    ts = tnets.RunningNormalizer(7, "cpu")
    for batch in (a, b):
        js = jnets.RunningNormalizer.update(js, jnp.asarray(batch))
        ts.update(torch.as_tensor(batch))
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(ts.state_dict()[k].numpy(), np.asarray(js[k]), rtol=1e-6)
    np.testing.assert_allclose(ts.normalize(torch.as_tensor(x)).numpy(),
                               np.asarray(jnets.RunningNormalizer.normalize(js, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_action_mean_switch_matches_two_pass(algs, rng):
    """The JAX rollout acts through the single-trunk DAgger switch
    (action_mean_switch, one jitted program for both flags); the port's
    eager rollout calls action_mean with the flag.  Equal for either latent
    (mirrors test_learning.py::test_switched_actor_matches_two_pass, across
    the two packages): float32, measured 4.8e-7 on means up to 1.0; held at
    1e-5."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    obs = rng.normal(0, 0.5, (32, ja.slices.total)).astype(np.float32)
    for flag in (True, False):
        want = ja.ac.apply(jts.ac_params, jnp.asarray(obs), jnp.asarray(flag),
                           method="action_mean_switch")
        with torch.no_grad():
            got = ts.ac.action_mean(torch.as_tensor(obs), flag)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("option", [dict(disc_loss_function="BCEWithLogitsLoss"),
                                    dict(disc_loss_function="Wasserstein"),
                                    dict(lr_schedule="fixed")])
def test_unported_algo_options_raise(algs, option):
    """The JAX trainer's other disc losses and its fixed learning rate are
    not ported: the port refuses them rather than train differently."""
    _, ta = algs
    with pytest.raises(NotImplementedError):
        tgail.SSInfoGAIL(ta.env, tgail.AlgoCfg(**{**KW, **option}), seed=0)


@pytest.mark.parametrize("module", ["dense", "conv", "disc_logit"])
def test_flax_initialisers_statistics(module):
    """flax_init_ gives lecun-normal kernels truncated at 2 sigma (variance
    1 / fan_in; fan_in = k x in for the conv), zero biases, a U(-1, 1)
    logit head and std = 1.  Sample moments over >= 20k weights, held at
    5% of the variance and 3 standard errors of the mean."""
    g = torch.Generator().manual_seed(0)
    if module == "dense":
        m = tnets.flax_init_(tnets.Discriminator(671), g).trunk[0]
        w, fan_in, lim = m.weight, 671, None
    elif module == "conv":
        ac = tnets.flax_init_(tnets.ActorCritic(tnets.ObsSlices()), g)
        assert torch.equal(ac.std, torch.ones(12))
        m = ac.history_encoder.conv0   # (20, 30, 4)
        w = torch.cat([tnets.flax_init_(tnets.ActorCritic(tnets.ObsSlices()), g)
                       .history_encoder.conv0.weight.flatten() for _ in range(9)])
        fan_in, lim = 30 * 4, None
    else:
        m = tnets.flax_init_(tnets.Discriminator(98, hidden=(512, 20000)), g).head_logit
        w, fan_in, lim = m.weight, None, 1.0
    w = w.detach().flatten().double()
    assert w.numel() >= 20000 and torch.equal(m.bias, torch.zeros_like(m.bias))
    if lim is None:
        var = 1.0 / fan_in
        sigma = np.sqrt(var) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * sigma + 1e-7
        assert abs(float(w.var()) / var - 1.0) < 0.05
        assert abs(float(w.mean())) < 3 * np.sqrt(var / w.numel())
    else:
        assert float(w.abs().max()) <= lim
        assert abs(float(w.var()) - 1.0 / 3.0) < 0.05 / 3.0
        assert abs(float(w.mean())) < 3 * np.sqrt(1.0 / 3.0 / w.numel())


def test_replay_ring_matches(rng):
    """Inserts that wrap the cursor, then gathers at JAX-drawn indices;
    exact."""
    jr = jreplay.init(32, 5)
    tr = treplay.Ring(32, 5, "cpu")
    for _ in range(5):
        rows = rng.normal(size=(8, 5)).astype(np.float32)
        jr = jreplay.insert(jr, jnp.asarray(rows))
        tr.insert(torch.as_tensor(rows))
        assert (tr.cursor, tr.size) == (int(jr.cursor), int(jr.size))
    np.testing.assert_array_equal(tr.data.numpy(), np.asarray(jr.data))
    key = jax.random.PRNGKey(4)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jr.size, 1))
    np.testing.assert_array_equal(tr.sample(torch.as_tensor(np.asarray(idx)).long()).numpy(),
                                  np.asarray(jreplay.sample(jr, key, 16)))
    with pytest.raises(ValueError):
        tr.insert(torch.zeros(5, 5))


@pytest.mark.parametrize("labeled", [True, False])
def test_expert_transitions_match(algs, labeled):
    """The trainer's expert preload (:161-177): JAX's clips and uniforms
    re-derived from its key chain fed to transition_frames, then the disc
    features; measured 1.2e-7 on frames, 2.6e-6 on features; held at
    2e-5."""
    ja, ta = algs
    jm, tm = ja.env.motion, ta.env.motion
    k4 = jax.random.split(jax.random.PRNGKey(0), 4)[3]
    key = k4 if labeled else jax.random.fold_in(k4, 1)
    P, L = ja.cfg.num_preload_transitions, ja.disc_obs_len
    kc, kt = jax.random.split(key)
    if labeled:
        logits = jnp.log(jnp.asarray(jm.weights, jnp.float32))
        clip = jax.random.categorical(kc, jnp.broadcast_to(logits, (P, jm.num_clips)), axis=-1)
    else:
        clip = jnp.zeros((P,), jnp.int32)
    u = jax.random.uniform(kt, (P,))
    want, want_lab = jm.sample_transition_frames(key, P, ja.env.dt, labeled, L)
    got, lab = tm.transition_frames(torch.as_tensor(np.asarray(clip)).long(),
                                    torch.as_tensor(np.asarray(u)), ta.env.dt, labeled, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    # the preload's features: the JAX trainer's tables from its seed
    feats = ta.expert_features(got)
    np.testing.assert_allclose(feats.numpy(),
                               np.asarray(ja.expert_lb if labeled else ja.expert_ulb), atol=2e-5)
    if labeled:
        np.testing.assert_array_equal(lab.numpy(), np.asarray(ja.expert_labels))
    # and the port's own draws give frames of the same kind
    f, _ = tm.sample_transition_frames(torch.Generator().manual_seed(0), 64, ta.env.dt,
                                       labeled, L)
    assert f.shape == (L, 64, 49) and bool(torch.isfinite(f).all())


def test_gae_matches(algs, rng):
    """compute_gae against JAX's and against tests/test_gae.py's O(T^2)
    oracle; measured 4.8e-7 against JAX (held at 1e-5) and held at the
    oracle test's 1e-3 / 1e-4."""
    ja, ta = algs
    T = 12
    rew = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.random((T, N)) < 0.15
    val = rng.normal(size=(T, N)).astype(np.float32)
    last = rng.normal(size=N).astype(np.float32)
    z = np.zeros((T, N, 1), np.float32)
    jtrs = jgail.Transition(obs=z, critic_obs=z, actions=z, rewards=rew, dones=done, values=val,
                            log_prob=z[..., 0], mean=z, std=z)
    jadv, jret = ja.compute_gae(jax.tree.map(jnp.asarray, jtrs), jnp.asarray(last))
    adv, ret = ta.compute_gae(port_transition(jtrs), torch.as_tensor(last))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-5)
    want = naive_gae(rew, done.astype(np.float32), val, last, ta.cfg.gamma, ta.cfg.lam)
    np.testing.assert_allclose(adv.numpy(), (want - want.mean()) / (want.std() + 1e-8),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), want + val, rtol=1e-3, atol=1e-4)


def test_ppo_update_matches(algs):
    """ppo_update from the same parameters, fresh Adam states and JAX's
    permutation, with the priv-reg term on (counter 1500): losses, the
    adaptive learning rate and every parameter afterwards.  Measured: metrics
    9.8e-7 relative, parameters 1.1e-6 (norm of the difference over the
    norm); held at 1e-4 and 1e-5."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))._replace(
        priv_reg_counter=jnp.asarray(1500, jnp.int32))
    ts = port_state(ta, jts)
    trs, adv, ret = rollout_inputs(ja, jts)
    key = jax.random.PRNGKey(7)
    jts2, jm = jax.jit(ja.ppo_update)(jts, trs, adv, ret, key)
    perm = torch.as_tensor(np.asarray(jax.random.permutation(key, trs.rewards.size))).long()
    tm = ta.ppo_update(ts, port_transition(trs), _t(adv), _t(ret), perm)
    merr, perr = metric_errors(tm, jm), param_errors(ts, jts2)
    assert float(ts.lr_ac) == float(jts2.lr_ac) != float(jts.lr_ac)
    assert max(merr.values()) < 1e-4, merr
    assert max(perr.values()) < 1e-5, perr


def test_disc_update_matches(algs, rng):
    """disc_update (80 -> 16 minibatches here) from the same parameters,
    normaliser and a ring of expert-like rows, JAX's minibatch indices,
    info-max on (learning_steps 250), task weight 0.6, and the policy std
    below its floor (the clamp acts): losses, accuracies, parameters,
    normaliser, prior and std afterwards.  Measured: metrics 6.0e-5
    relative, parameters 1.9e-4 (one trunk unit's pre-activation comes
    within 3.3e-6 of zero on a row of minibatch 14, and the sides part
    there); held at 2e-4 and 1e-3."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    cap = jts.ring.data.shape[0]
    lb = np.asarray(ja.expert_lb)
    feats = lb[rng.integers(0, lb.shape[0], cap)] + rng.normal(0, 0.1, (cap, lb.shape[1]))
    c = np.eye(5)[rng.integers(0, 5, cap)]
    data = np.concatenate([feats, rng.uniform(-1, 1, (cap, 1)), c], -1).astype(np.float32)
    ac = jax.tree.map(lambda x: x, jts.ac_params)
    ac["params"]["std"] = jnp.full((12,), 0.01, jnp.float32)
    jts = jts._replace(
        ring=jreplay.Ring(jnp.asarray(data), jnp.asarray(0, jnp.int32), jnp.asarray(400, jnp.int32)),
        learning_steps=jnp.asarray(250, jnp.int32), task_obs_weight=jnp.float32(0.6),
        ac_params=ac)
    ts = port_state(ta, jts)
    key = jax.random.PRNGKey(9)
    jts2, jm = jax.jit(ja.disc_update)(jts, key)
    tm = ta.disc_update(ts, disc_draws(ja, key, 400))
    merr, perr = metric_errors(tm, jm), param_errors(ts, jts2)
    assert max(merr.values()) < 2e-4, merr
    assert max(perr.values()) < 1e-3, perr
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(ts.disc_norm.state_dict()[k].numpy(),
                                   np.asarray(jts2.disc_norm[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.prior_parameters.numpy(), np.asarray(jts2.prior_parameters),
                               rtol=1e-5)
    np.testing.assert_array_equal(ts.ac.std.detach().numpy(),
                                  np.asarray(jts2.ac_params["params"]["std"]))
    assert (ts.learning_steps, ts.priv_reg_counter) == (251, 1)


def test_dagger_update_matches(algs):
    """dagger_update from the same parameters and JAX's permutation: the
    history encoder afterwards (the rest unchanged) and the counter.
    Measured: loss 9.6e-8 relative, parameters 7.5e-9; held at 1e-4, 1e-5."""
    ja, ta = algs
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ts = port_state(ta, jts)
    trs, _, _ = rollout_inputs(ja, jts, seed=1)
    key = jax.random.PRNGKey(11)
    jts2, jm = jax.jit(ja.dagger_update)(jts, trs, key)
    perm = torch.as_tensor(np.asarray(jax.random.permutation(key, trs.rewards.size))).long()
    tm = ta.dagger_update(ts, port_transition(trs), perm)
    merr, perr = metric_errors(tm, jm), param_errors(ts, jts2)
    assert max(merr.values()) < 1e-4, merr
    assert max(perr.values()) < 1e-5, perr
    assert ts.priv_reg_counter == int(jts2.priv_reg_counter) == 1


def test_slim_checkpoint_reads_back(algs, tmp_path):
    """The slim checkpoint of a port runner is read by the JAX package's
    checkpoint.load_into into the JAX runner's checkpoint_tree template,
    every leaf equal; and by the port's play loader to equal tensors."""
    ja, ta = algs
    r = trunner.OnPolicyRunner(ta.env, ta.cfg, log_dir=str(tmp_path), seed=2)
    r.current_iteration = 7
    r.train_state.lr_ac = np.float32(0.00123)
    r.train_state.disc_norm.update(torch.randn(5, ta.disc_in))
    path = r.save(7, full=False)
    assert os.path.basename(path) == "model_7.msgpack" and tckpt.sibling_state(path) is None
    template = jrunner.OnPolicyRunner.checkpoint_tree(types.SimpleNamespace(
        train_state=ja.init_train_state(jax.random.PRNGKey(0)), current_iteration=0))
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
    # the port's play_bbc loader
    sd = tckpt.params_from_jax(tckpt.read_msgpack(path))
    for k, m in (("actor_critic", r.train_state.ac), ("estimator", r.train_state.est),
                 ("discriminator", r.train_state.disc)):
        want = m.state_dict()
        assert sd[k].keys() == want.keys()
        for name, v in sd[k].items():
            assert torch.equal(v, want[name]), (k, name)
    # and flax's own encoder writes the same bytes for the same tree
    with open(path, "rb") as f:
        assert f.read() == ser.to_bytes(mine)
