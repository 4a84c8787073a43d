"""The port's recurrent actor-critic (learn/recurrent.py) against the JAX
package's (agility_tpu/learn/recurrent.py): the same flax parameters,
carried across with recurrent.params_from_jax (every leaf moved off its
initial value, so the zero-initialised biases count too), the same
numpy-seeded observations, four steps with some envs reset before the
third, for the LSTM and the GRU memory.  Tolerance 1e-6 absolute on the
action means, values and carries (float32 matrix products of a few
dozen terms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agility_tpu.learn import recurrent as jrec
from agility_tpu_torch.learn import recurrent as trec

B, OBS, CRIT, H, A = 6, 11, 9, 8, 3
TOL = 1e-6


def _jax_model(rnn_type):
    return jrec.ActorCriticRecurrent(num_actions=A, num_obs=OBS, hidden_size=H,
                                     rnn_type=rnn_type, actor_hidden=(7, 5),
                                     critic_hidden=(6,), init_noise_std=0.7)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_recurrent_actor_critic_matches_flax(rnn_type, rng):
    jm = _jax_model(rnn_type)
    obs = rng.normal(size=(4, B, OBS)).astype(np.float32)
    cobs = rng.normal(size=(4, B, CRIT)).astype(np.float32)
    dones = rng.random((4, B)) < 0.4
    carry_a = carry_c = jrec.Memory(H, rnn_type).initialize_carry(B)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(obs[0]), jnp.asarray(cobs[0]),
                        carry_a, carry_c)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    variables = jax.tree_util.tree_unflatten(
        treedef, [x + 0.1 * rng.normal(size=x.shape).astype(np.float32) for x in leaves])

    tm = trec.ActorCriticRecurrent(num_obs=OBS, num_critic_obs=CRIT, num_actions=A,
                                   hidden_size=H, rnn_type=rnn_type, actor_hidden=(7, 5),
                                   critic_hidden=(6,), init_noise_std=0.7)
    sd = trec.params_from_jax(variables)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    t_a, t_c = tm.init_carries(B, "cpu")
    step = jax.jit(jm.apply)
    for t in range(4):
        if t == 2:
            d = dones[t]
            carry_a, carry_c = (jrec.reset_carry(c, jnp.asarray(d)) for c in (carry_a, carry_c))
            t_a, t_c = (trec.reset_carry(c, torch.as_tensor(d)) for c in (t_a, t_c))
        jmean, jstd, jval, carry_a, carry_c = step(variables, jnp.asarray(obs[t]),
                                                   jnp.asarray(cobs[t]), carry_a, carry_c)
        with torch.no_grad():
            mean, std, val, t_a, t_c = tm(torch.as_tensor(obs[t]), torch.as_tensor(cobs[t]),
                                          t_a, t_c)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=TOL, rtol=0)
        np.testing.assert_allclose(val.numpy(), np.asarray(jval), atol=TOL, rtol=0)
        np.testing.assert_array_equal(std.detach().numpy(), np.asarray(jstd))
        for mine, theirs in ((t_a, carry_a), (t_c, carry_c)):
            got = mine if isinstance(mine, tuple) else (mine,)
            want = jax.tree_util.tree_leaves(theirs)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_recurrent_carry_shapes_and_reset(rnn_type):
    """Zero carries of the JAX layout ((c, h) for the LSTM, h for the GRU);
    reset_carry zeroes the done rows alone; an unknown cell type raises;
    flax_init_ draws every kernel and leaves the biases zero."""
    tm = trec.ActorCriticRecurrent(num_obs=OBS, num_actions=A, hidden_size=H, rnn_type=rnn_type)
    ca, cc = tm.init_carries(B, "cpu")
    want = jrec.Memory(H, rnn_type).initialize_carry(B)
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(want)] == \
        [tuple(x.shape) for x in (ca if isinstance(ca, tuple) else (ca,))]
    ones = tuple(torch.ones_like(c) for c in ca) if isinstance(ca, tuple) else torch.ones_like(ca)
    dones = torch.tensor([True, False, True, False, False, False])
    out = trec.reset_carry(ones, dones)
    for c in (out if isinstance(out, tuple) else (out,)):
        assert torch.equal(c[:, 0], (~dones).float())
    tm.flax_init_(torch.Generator().manual_seed(0))
    for n, p in tm.named_parameters():
        if n == "std":
            assert torch.equal(p.detach(), torch.ones(A))
        else:   # biases zero, kernels drawn
            assert (float(p.detach().abs().max()) == 0.0) == ("b_" in n or n.endswith("bias")), n
    with pytest.raises(ValueError):
        trec.Memory(OBS, H, "rnn")
