"""The port's policy networks and checkpoint reader vs flax.

`logs/bbc_r5/bbc_15k.msgpack` (the trained BBC at 15k iterations) is read by
the port's own msgpack decoder and by flax; its parameters drive both the
flax modules and the port's torch modules on the same observations.
Tolerance: float32 on both sides with different matmul/conv summation
orders through a 5-layer network; actions agree to 2e-5 on a ~1 scale.
"""
import os

import numpy as np
import flax.serialization as ser
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.learn import networks as jnets
from agility_tpu_torch.envs.config import Go2LocomotionCfg
from agility_tpu_torch.io import checkpoint as ckpt
from agility_tpu_torch.learn import networks as tnets
from agility_tpu_torch.learn.policy import InferencePolicy, build_policy

CKPT = os.path.join(os.path.dirname(__file__), "..", "logs", "bbc_r5", "bbc_15k.msgpack")


@pytest.fixture(scope="module")
def trees():
    with open(CKPT, "rb") as f:
        ref = ser.msgpack_restore(f.read())
    return ckpt.read_msgpack(CKPT), ref


def test_msgpack_reader_matches_flax(trees):
    got, ref = trees
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_g, flat_r):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_policy_actions_match_flax(trees, rng):
    got, ref = trees
    slices = jnets.ObsSlices()
    ac, est = jnets.ActorCritic(num_actions=12, slices=slices), jnets.Estimator(output_dim=4)
    obs = rng.normal(0, 1.0, (16, slices.total)).astype(np.float32)
    o = jnp.asarray(obs)
    # the JAX runner's get_inference_policy
    pred = est.apply(ref["est_params"], o[:, slices.prop])
    o2 = o.at[:, slices.explicit].set(pred)
    want = ac.apply(ref["ac_params"], o2, method="action_mean", hist_encoding=True)

    policy = build_policy(Go2LocomotionCfg(), ckpt.params_from_jax(got), "cpu")
    t = torch.as_tensor(obs)
    np.testing.assert_allclose(policy(t).numpy(), np.asarray(want), atol=2e-5)
    # the pieces: both latents, the privileged-latent actor and the critic
    pac = policy.ac
    with torch.no_grad():
        for name in ("hist_latent", "priv_latent", "value"):
            a = getattr(pac, name)(t)
            b = ac.apply(ref["ac_params"], o, method=name)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)
        a = pac.action_mean(t, hist_encoding=False)
    b = ac.apply(ref["ac_params"], o, method="action_mean", hist_encoding=False)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_random_policy_is_seeded():
    a, b = (build_policy(Go2LocomotionCfg(), device="cpu", seed=3) for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert isinstance(a, InferencePolicy) and isinstance(a.ac, tnets.ActorCritic)
