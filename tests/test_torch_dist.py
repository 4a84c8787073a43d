"""Env-axis data parallelism in the port (agility_tpu_torch/dist/mesh.py and
the shard-aware envs, trainers and runners): a W-rank run of seed s is the
1-rank run of seed s, partitioned by env, as the JAX package's GSPMD runs
are (tests/test_dist.py).

Each test starts its ranks with mesh.launch (spawned processes, a gloo
group on a free local port, a 60 s init timeout and the test's own time
limit, so that a dead rank fails the test instead of hanging it); the
work in each rank is tests/torch_dist_cases.py's, and the 1-rank run is
the same work in this process without a group.

Tolerances are the JAX suite's (tests/test_dist.py:31-36,61-66,95-99):
per-env states and step outputs 1e-5 absolute; `rollout/r_total` 1e-4
relative; parameters 1e-3 relative and 1e-4 absolute.  Sums over the
envs split in two partial sums, and the CPU's matrix products round
differently at another batch size; the ranks' parameters must be
bit-identical, and the TSC env's success EMAs and curriculum count equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from agility_tpu.envs import config as jcfg
from agility_tpu.envs import go2_locomotion as jenv
from agility_tpu.learn import ssinfogail as jgail
from agility_tpu_torch.dist import mesh
from agility_tpu_torch.io import checkpoint as tckpt
from test_torch_train import KW, N, metric_errors, rollout_inputs

W = 2
STATE_TOL = 1e-5


@pytest.fixture(autouse=True)
def keep_threads():
    """The cases run on one intra-op thread (their ops are small); give
    the worker its threads back afterwards."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def two_ranks(fn, *args, timeout_s=90.0):
    return mesh.launch(fn, W, args=args, device="cpu", timeout_s=timeout_s)


def test_env_shard_take_gather_round_trip():
    """take/gather_rows give back the global tensor (bools too); the
    ranks' minibatch rows of a permutation are, together, that
    permutation's minibatches; broadcast_module_ gives every rank rank 0's
    weights; a world that does not divide the envs raises."""
    out = two_ranks(cases.shard_round_trip)
    g = torch.arange(60, dtype=torch.float32).reshape(12, 5)
    assert torch.equal(torch.cat([o["mine"] for o in out]), g)
    for o in out:
        assert torch.equal(o["back"], g)
        assert torch.equal(o["flags"], torch.arange(12) % 3 == 0)
        assert torch.equal(o["weight"], torch.zeros(2, 3))     # rank 0's, broadcast
    perm = out[0]["perm"]
    for j in range(4):
        got = torch.cat([o["rows"][j] for o in out])
        assert sorted(got.tolist()) == sorted(perm[j * 9:(j + 1) * 9].tolist())
    with pytest.raises(ValueError):
        mesh.EnvShard(0, 3, 16)
    with pytest.raises(ValueError):
        mesh.EnvShard(2, 2, 16)
    s = mesh.EnvShard(1, 4, 16)
    assert (s.offset, s.local) == (4, 4)
    x = np.arange(32).reshape(16, 2)
    np.testing.assert_array_equal(s.take(x), x[4:8])
    assert s.take(torch.zeros(5)).shape == (5,)          # not per env: unchanged


def test_bbc_iteration_two_ranks_match_one():
    """One SSInfoGAIL iteration (iteration 0: DAgger included) on JAX's
    sharded-iteration configuration: the ranks' parameters bit-identical;
    against the 1-rank run, rollout/r_total at 1e-4, the parameters at
    1e-3 / 1e-4, the replicated ring and the end states' rows at 1e-5."""
    one = cases.bbc_iteration()
    two = two_ranks(cases.bbc_iteration)
    assert torch.equal(two[0]["params"], two[1]["params"])
    assert torch.equal(two[0]["ring"], two[1]["ring"])
    np.testing.assert_allclose(two[0]["metrics"]["rollout/r_total"],
                               one["metrics"]["rollout/r_total"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["params"].numpy(), one["params"].numpy(), rtol=1e-3,
                               atol=1e-4)
    assert two[0]["ring"].shape == one["ring"].shape == (4 * 16, 104)
    np.testing.assert_allclose(two[0]["ring"].numpy(), one["ring"].numpy(), rtol=STATE_TOL,
                               atol=STATE_TOL)
    for k in ("base_pos", "base_quat", "dof_pos"):
        np.testing.assert_allclose(torch.cat([o["sim"][k] for o in two]).numpy(),
                                   one["sim"][k].numpy(), atol=STATE_TOL)
    np.testing.assert_allclose(torch.cat([o["obs"] for o in two]).numpy(), one["obs"].numpy(),
                               atol=STATE_TOL)
    assert two[0]["metrics"]["ppo/lr"] == one["metrics"]["ppo/lr"]
    merr = metric_errors(two[0]["metrics"], one["metrics"])
    assert max(merr.values()) < 1e-4, merr


def test_tsc_env_steps_two_ranks_match_one():
    """Three TSC env steps on 16 envs, 2 courses, the curriculum on: a
    quarter of the envs finish their course in the first step and the
    curriculum is due there.  Obs, rewards and base positions at 1e-5;
    the success EMAs, goal progress and curriculum count equal on every
    rank and to the 1-rank run's."""
    one = cases.tsc_env_steps()
    two = two_ranks(cases.tsc_env_steps)
    assert bool(one[0]["reset"].any()) and one[0]["success_rate"] != 0.9
    assert one[0]["curr_count"] == 1
    for t in range(len(one)):
        for k in ("obs", "rew", "base_pos"):
            np.testing.assert_allclose(torch.cat([o[t][k] for o in two]).numpy(),
                                       one[t][k].numpy(), atol=STATE_TOL)
        assert torch.equal(torch.cat([o[t]["reset"] for o in two]), one[t]["reset"])
        for k in ("success_rate", "success_rate_s0", "goal_progress", "curr_count"):
            assert two[0][t][k] == two[1][t][k] == one[t][k], (t, k)


def test_tsc_iteration_two_ranks_match_one():
    """One TscPPO iteration (0: DAgger included) on 16 envs, 2 courses,
    with the fresh frozen BBC: the ranks' parameters bit-identical;
    rollout/r_total at 1e-4 and the parameters at 1e-3 / 1e-4 against
    the 1-rank run; the end states' rows at 1e-5; the learning rate and
    success EMA equal."""
    one = cases.tsc_iteration()
    two = two_ranks(cases.tsc_iteration)
    assert torch.equal(two[0]["params"], two[1]["params"])
    np.testing.assert_allclose(two[0]["metrics"]["rollout/r_total"],
                               one["metrics"]["rollout/r_total"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["params"].numpy(), one["params"].numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(torch.cat([o["sim"]["base_pos"] for o in two]).numpy(),
                               one["sim"]["base_pos"].numpy(), atol=STATE_TOL)
    assert two[0]["lr"] == two[1]["lr"] == one["lr"]
    assert two[0]["success_rate"] == two[1]["success_rate"] == one["success_rate"]


def test_gae_and_ppo_two_ranks_match_jax():
    """The port's GAE with its normalisation over both ranks, and its PPO
    update on each rank's envs of a numpy-seeded global rollout with JAX's
    permutation injected, against the JAX package's compute_gae and
    ppo_update (priv-reg on, counter 1500), at tests/test_torch_train.py's
    1-rank tolerances: GAE 1e-5, metrics 1e-4 relative, parameters 1e-5
    (norm of the difference over the norm), the learning rate equal."""
    ja = jgail.SSInfoGAIL(jenv.Go2LocomotionEnv(jcfg.smoke_cfg(N)), jgail.AlgoCfg(**KW), seed=0)
    jts = ja.init_train_state(jax.random.PRNGKey(1))._replace(
        priv_reg_counter=jnp.asarray(1500, jnp.int32))
    trs, adv, ret = rollout_inputs(ja, jts)
    key = jax.random.PRNGKey(7)
    jts2, jm = jax.jit(ja.ppo_update)(jts, trs, adv, ret, key)
    last = ja.ac.apply(jts.ac_params, trs.obs[-1], method="value")
    sd = tckpt.params_from_jax({"ac_params": jts.ac_params, "est_params": jts.est_params,
                                "disc_params": jts.disc_params})
    inputs = dict(num_envs=N, kw=KW, ac=sd["actor_critic"], est=sd["estimator"],
                  lr=float(jts.lr_ac), priv_reg_counter=1500,
                  trs=[np.asarray(x) for x in trs], last=np.asarray(last),
                  adv=np.asarray(adv), ret=np.asarray(ret),
                  perm=np.asarray(jax.random.permutation(key, trs.rewards.size)).astype(np.int64))
    two = two_ranks(cases.gae_and_ppo, inputs)
    np.testing.assert_allclose(torch.cat([o["adv"] for o in two], 1).numpy(), np.asarray(adv),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([o["ret"] for o in two], 1).numpy(), np.asarray(ret),
                               rtol=1e-5, atol=1e-5)
    assert two[0]["lr"] == two[1]["lr"] == float(jts2.lr_ac) != float(jts.lr_ac)
    merr = metric_errors(two[0]["metrics"], jm)
    assert max(merr.values()) < 1e-4, merr
    got = tckpt.params_to_jax(two[0]["ac"], two[0]["est"], two[0]["disc"])
    for k in ("ac_params", "est_params"):
        g = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(got[k])])
        w = np.concatenate([np.ravel(np.asarray(x))
                            for x in jax.tree_util.tree_leaves(getattr(jts2, k))])
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-5, k
    for a, b in zip(two[0]["ac"].values(), two[1]["ac"].values()):
        assert torch.equal(a, b)


def _assert_resumed(loaded, saved_parts):
    """A runner state resumed from a checkpoint equals the saving run's:
    the env rows (as the ranks' rows concatenated), the parameters, ring,
    generator states and iteration."""
    for k in ("base_pos", "base_quat", "dof_pos", "u"):
        assert torch.equal(loaded["sim"][k], torch.cat([p["sim"][k] for p in saved_parts])), k
    assert torch.equal(loaded["episode_length"],
                       torch.cat([p["episode_length"] for p in saved_parts]))
    assert torch.equal(loaded["disc_hist"], torch.cat([p["disc_hist"] for p in saved_parts]))
    ref = saved_parts[0]
    assert torch.equal(loaded["params"], ref["params"])
    assert torch.equal(loaded["ring"], ref["ring"]) and loaded["ring_size"] == ref["ring_size"]
    for a, b in zip(loaded["gen"], ref["gen"]):
        assert torch.equal(a, b)
    assert loaded["iteration"] == ref["iteration"] == 1


def test_checkpoint_resumes_across_world_sizes(tmp_path):
    """A 2-rank run's exact-resume checkpoint (written by rank 0, in the
    1-rank layout) resumed by one process, and a 1-rank checkpoint resumed
    by 2 ranks, each taking its envs: equal state."""
    two_dir, one_dir = str(tmp_path / "two"), str(tmp_path / "one")
    saved_two = two_ranks(cases.train_and_save, two_dir)
    loaded_one = cases.load_from(str(tmp_path / "scratch1"), two_dir)
    _assert_resumed(loaded_one, saved_two)

    saved_one = cases.train_and_save(one_dir)
    loaded_two = two_ranks(cases.load_from, str(tmp_path / "scratch2"), one_dir)
    for r, part in enumerate(loaded_two):
        shard = mesh.EnvShard(r, W, cases.BBC_ENVS)
        want = dict(saved_one, sim={k: shard.take(v) for k, v in saved_one["sim"].items()},
                    episode_length=shard.take(saved_one["episode_length"]),
                    disc_hist=shard.take(saved_one["disc_hist"]))
        _assert_resumed(part, [want])
