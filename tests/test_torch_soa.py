"""PyTorch port of the env-minor SoA substep vs agility_tpu.physics.soa.

The same numpy batch of states goes through each JAX function and its port,
function by function (FK, mass factors + solve, bias forces, contact
geometry, Delassus blocks, patch sampling, limit impulses), then one substep
warm-started from nonzero impulses and one 4-substep control step, warm
(5 sweeps) and cold (10 sweeps), on a rough grid with randomized per-env
parameters.  The port runs the contact sweeps through K1's plain version
(CPU tensors); the JAX side runs eagerly (jax.disable_jit) because its
scalar-unrolled HLO takes minutes to compile on XLA-CPU.

Tolerances: the two sides evaluate the same float32 formulas, differing only
in summation order (einsum/bmm vs sequential sums), so the per-function
checks hold to 1e-5 relative; the control step holds well inside
tests/test_soa.py's SoA-vs-oracle tolerances (base_pos 5e-4, u 3e-2,
torques 1e-3): measured max |du| ~4e-5 on this batch.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.core.urdf import build_go2_model as j_build
from agility_tpu.physics import engine as jeng
from agility_tpu.physics import heightfield as jhf
from agility_tpu.physics import soa as jsoa
from agility_tpu.physics.constants import ModelConsts as JMC
from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import soa as tsoa
from agility_tpu_torch.physics.constants import ModelConsts

JMC_ = JMC.from_model(j_build())
TMC = ModelConsts.from_model(build_go2_model(), "cpu")
JC, TC = jsoa.consts_of(JMC_), tsoa.consts_of(TMC)
N = 4
GRAV = (0.0, 0.0, -9.81)


def np_batch(rng, n=N, z=0.30, spread=0.3):
    bp = np.concatenate([rng.normal(0, 0.2, (n, 2)), np.full((n, 1), z)], -1)
    q = rng.normal(0, 0.1, (n, 4)) + np.array([0, 0, 0, 1.0])
    bq = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qj = np.asarray(JMC_.default_dof_pos) + rng.uniform(-spread, spread, (n, 12))
    u = rng.normal(0, 0.3, (n, 18))
    return [np.asarray(x, np.float32) for x in (bp, bq, qj, u)]


def both(arrs):
    """(jax tuple, torch tuple) of the same numpy arrays."""
    return (tuple(jnp.asarray(a) for a in arrs), tuple(torch.as_tensor(a) for a in arrs))


def links(rng):
    bp, bq, qj, u = np_batch(rng)
    (jbp, jbq, jq, ju), (tbp, tbq, tq, tu) = both([bp.T, bq.T, qj.T, u.T])
    jls = jsoa.fk_vel(JC, tuple(jbp), tuple(jbq), jq, ju)
    tls = tsoa.fk_vel(TC, tuple(tbp), tuple(tbq), tq, tu)
    return jls, tls, (jq, ju), (tq, tu)


def close(t, j, rtol=1e-5, atol=1e-5, msg=""):
    """Compare nested lists/tuples of torch tensors against jax arrays."""
    if isinstance(t, (list, tuple)):
        assert len(t) == len(j), msg
        for a, b in zip(t, j):
            close(a, b, rtol, atol, msg)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


def test_fk_vel_and_coms_match(rng):
    jls, tls, _, _ = links(rng)
    for k in ("pos", "quat", "omega", "vel", "axes"):
        close(tls[k], jls[k], msg=k)
    shift = rng.uniform(-0.05, 0.05, (3, N)).astype(np.float32)
    close(tsoa.link_coms(TC, tls, tuple(torch.as_tensor(shift))),
          jsoa.link_coms(JC, jls, tuple(jnp.asarray(shift))))


def test_body_positions_match(rng):
    bp, bq, qj, u = np_batch(rng)
    (jb, jqt, jqj, ju), (tb, tqt, tqj, tu) = both([bp, bq, qj, u])
    idx = [0, 4, 8, 12, 16]
    ref = jsoa.body_positions(JMC_, jeng.EnvState(jb, jqt, jqj, ju), idx)
    got = tsoa.body_positions(TMC, teng.EnvState(tb, tqt, tqj, tu), idx)
    close(got, ref)


def test_mass_factors_and_solve_match(rng):
    jls, tls, _, _ = links(rng)
    am = rng.uniform(0, 1.5, N).astype(np.float32)
    jf = jsoa.mass_factors(JC, jls, jsoa.link_coms(JC, jls), jnp.asarray(am))
    tf = tsoa.mass_factors(TC, tls, tsoa.link_coms(TC, tls), torch.as_tensor(am))
    for k in ("Dinv", "B", "BDinv", "Sinv"):
        close(tf[k], jf[k], rtol=1e-4, msg=k)
    rhs = rng.normal(0, 1.0, (18, N)).astype(np.float32)
    close(tsoa.solve(tf, list(torch.as_tensor(rhs))), jsoa.solve(jf, list(jnp.asarray(rhs))),
          rtol=1e-4)


def test_bias_forces_match(rng):
    jls, tls, (_, ju), (_, tu) = links(rng)
    am = rng.uniform(0, 1.5, N).astype(np.float32)
    ref = jsoa.bias_forces(JC, jls, jsoa.link_coms(JC, jls), [ju[6 + d] for d in range(12)],
                           GRAV, jnp.asarray(am))
    got = tsoa.bias_forces(TC, tls, tsoa.link_coms(TC, tls), list(tu[6:].unbind(0)),
                           GRAV, torch.as_tensor(am))
    close(got, ref, rtol=1e-5, atol=1e-4)


def test_contact_geometry_and_delassus_match(rng):
    jls, tls, _, _ = links(rng)
    jcen, jlev = jsoa.sphere_geometry(JC, jls)
    tcen, tlev = tsoa.sphere_geometry(TC, tls)
    close(tcen, jcen)
    close(tlev, jlev)
    jr = tuple(jcen[k] - jls["pos"][0][k][None] for k in range(3))
    tr = tuple(tcen[k] - tls["pos"][0][k][None] for k in range(3))
    w = rng.normal(size=(18, N)).astype(np.float32)
    close(tsoa.apply_J(list(torch.as_tensor(w)), tr, tlev),
          jsoa.apply_J(list(jnp.asarray(w)), jr, jlev))
    lam = rng.normal(size=(3, TC.S, N)).astype(np.float32)
    close(tsoa.apply_JT(torch.as_tensor(lam), tr, tlev),
          jsoa.apply_JT(jnp.asarray(lam), jr, jlev), atol=1e-4)
    jf = jsoa.mass_factors(JC, jls, jsoa.link_coms(JC, jls))
    tf = tsoa.mass_factors(TC, tls, tsoa.link_coms(TC, tls))
    # inverse blocks of small Delassus diagonals reach ~1e3: relative check
    close(tsoa.delassus_diag_inv(tf, tr, tlev), jsoa.delassus_diag_inv(jf, jr, jlev, jnp.float32),
          rtol=1e-4, atol=1e-3)


def test_patch_sample_hn_matches(rng):
    P = 24
    vals = (0.08 * rng.normal(size=(P, P, N))).astype(np.float32)
    x0 = rng.integers(0, 20, N)
    y0 = rng.integers(0, 20, N)
    origin, hs = (-1.2, -1.0), 0.05
    # points inside and outside each env's window (clamped)
    x = (origin[0] + hs * (x0[None] + rng.uniform(-2, P + 2, (24, N)))).astype(np.float32)
    y = (origin[1] + hs * (y0[None] + rng.uniform(-2, P + 2, (24, N)))).astype(np.float32)
    ref = jsoa.patch_sample_hn(jnp.asarray(vals), jnp.asarray(x0, jnp.int32),
                               jnp.asarray(y0, jnp.int32), jnp.asarray(origin, jnp.float32),
                               hs, jnp.asarray(x), jnp.asarray(y))
    got = tsoa.patch_sample_hn(torch.as_tensor(vals), torch.as_tensor(x0),
                               torch.as_tensor(y0), origin, hs, torch.as_tensor(x),
                               torch.as_tensor(y))
    close(got[0], ref[0], atol=2e-6)
    close(got[1], ref[1], atol=1e-5)


def _limit_case(rng):
    """States pushed through the dof limits with violent joint velocities."""
    jls, tls, (jq, ju), (tq, tu) = links(rng)
    lo, hi = np.asarray(JC.lower), np.asarray(JC.upper)
    q = np.where(rng.random((12, N)) < 0.5, lo[:, None] - 0.01, hi[:, None] + 0.01)
    u = rng.normal(0, 20.0, (18, N)).astype(np.float32)
    jf = jsoa.mass_factors(JC, jls, jsoa.link_coms(JC, jls))
    tf = tsoa.mass_factors(TC, tls, tsoa.link_coms(TC, tls))
    return jf, tf, q.astype(np.float32), u, (tls, tq)


def test_limit_impulses_match(rng):
    jf, tf, q, u, _ = _limit_case(rng)
    ref = jsoa.limit_impulses(JC, jf, jnp.asarray(u), jnp.asarray(q), 0.005)
    got = tsoa.limit_impulses(TC, tf, torch.as_tensor(u), torch.as_tensor(q), 0.005)
    assert np.abs(got.numpy() - u).max() > 1.0           # the limits did act
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)


def test_limit_impulses_conserve_momentum(rng):
    """Joint-space impulses through M^-1 cannot change the total linear
    momentum sum_l m_l v_com,l (the clamp it replaced deleted limb momentum
    with no reaction: tests/test_dynamics.py)."""
    _, tf, q, u, (tls, tq) = _limit_case(rng)
    u = torch.as_tensor(u)
    u2 = tsoa.limit_impulses(TC, tf, u, torch.as_tensor(q), 0.005)

    def momentum(uu):
        # velocities at the configuration the mass factors were built for
        ls = tsoa.fk_vel(TC, tls["pos"][0], tls["quat"][0], tq, uu)
        com = tsoa.link_coms(TC, ls)
        P = [0.0, 0.0, 0.0]
        for l in range(TC.L):
            v = tsoa.v_add(ls["vel"][l], tsoa.v_cross(ls["omega"][l],
                                                      tsoa.v_sub(com[l], ls["pos"][l])))
            P = [P[k] + float(TC.link_mass[l]) * v[k] for k in range(3)]
        return torch.stack(P)

    dP = momentum(u2) - momentum(u)
    assert float((u2 - u)[6:].abs().max()) > 1.0          # joints were pushed back
    # float32 roundoff of ~100 kg m/s link momenta
    assert float(dP.abs().max()) < 2e-3, dP


def _rough():
    rng = np.random.default_rng(7)
    h = (0.08 * rng.normal(size=(48, 48))).astype(np.float32)
    return (jhf.from_numpy(h, 0.05, origin_xy=(-1.2, -1.2)),
            thf.from_numpy(h, 0.05, origin_xy=(-1.2, -1.2), device="cpu"))


def _step_inputs(rng):
    bp, bq, qj, u = np_batch(rng, z=0.30)
    tgt = (np.asarray(JMC_.default_dof_pos) + rng.uniform(-0.2, 0.2, (N, 12))).astype(np.float32)
    prm = [rng.uniform(0.6, 1.2, N), rng.uniform(0.8, 1.2, (N, 12)),
           rng.uniform(0.8, 1.2, (N, 12)), rng.uniform(0, 1.5, N),
           rng.uniform(-0.05, 0.05, (N, 3))]
    prm = [np.asarray(p, np.float32) for p in prm]
    kp, kd = np.full((N, 12), 40.0, np.float32), np.full((N, 12), 1.0, np.float32)
    (js, jctl, jprm), (ts, tctl, tprm) = [
        (eng.EnvState(*conv(bp, bq, qj, u)), eng.Control(*conv(tgt, kp, kd)),
         eng.EnvParams(*conv(*prm)))
        for eng, conv in ((jeng, lambda *a: [jnp.asarray(x) for x in a]),
                          (teng, lambda *a: [torch.as_tensor(x) for x in a]))]
    return (js, jctl, jprm), (ts, tctl, tprm)


@pytest.fixture(scope="module")
def step_pair():
    """One rough-grid batch through both control steps, warm and cold; the
    JAX side is computed once per module (eager, ~10-20 s each)."""
    rng = np.random.default_rng(0)
    (js, jctl, jprm), (ts, tctl, tprm) = _step_inputs(rng)
    jg, tg = _rough()
    out = {}
    for name, warm, iters in (("warm", True, 5), ("cold", False, 10)):
        with jax.disable_jit():
            ref = jsoa.control_step_batched(
                JMC_, jeng.EngineConfig(warm_start=warm, jacobi_iters=iters), jg, js, jctl, jprm)
        got = tsoa.control_step_batched(
            TMC, teng.EngineConfig(warm_start=warm, jacobi_iters=iters), tg, ts, tctl, tprm)
        out[name] = (ref, got)
    return out


@pytest.mark.parametrize("mode", ["warm", "cold"])
def test_control_step_batched_matches(step_pair, mode):
    ref, got = step_pair[mode]
    (s, taus, bf, mbf, patch), (rs, rtaus, rbf, rmbf, rpatch) = got, ref
    tol = dict(base_pos=1e-5, base_quat=1e-5, dof_pos=1e-5, u=1e-3)
    for k, atol in tol.items():
        np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(rs, k)),
                                   atol=atol, err_msg=k)
    for a, b in zip(taus, rtaus):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=5e-4)
    # contact forces: impulses / dt, several hundred N on this batch
    np.testing.assert_allclose(bf.numpy(), np.asarray(rbf), atol=2e-2)
    np.testing.assert_allclose(mbf.numpy(), np.asarray(rmbf), atol=2e-2)
    assert float(mbf.abs().max()) > 10.0                 # contacts were active
    np.testing.assert_array_equal(patch.values.numpy(), np.asarray(rpatch.values))


def test_substep_warm_start_matches(rng):
    """One substep from nonzero carried impulses (the lam0 warm start)."""
    (js, jctl, jprm), (ts, tctl, tprm) = _step_inputs(rng)
    jg, tg = _rough()
    cfg_j = jeng.EngineConfig(warm_start=True, jacobi_iters=5)
    cfg_t = teng.EngineConfig(warm_start=True, jacobi_iters=5)
    sd, (target, kp, kd, prm, sampler, _), _ = tsoa.batch_inputs(cfg_t, tg, ts, tctl, tprm)
    lam0 = np.abs(rng.normal(0, 0.05, (3, TC.S, N))).astype(np.float32)
    got = tsoa.substep(TMC, cfg_t, sd, target, kp, kd, prm, sampler, lam0=torch.as_tensor(lam0))

    from agility_tpu.physics import patch as jpt
    p = jpt.extract_batch(jg, js.base_pos[:, :2], 24)
    vT = jnp.transpose(p.values, (1, 2, 0))
    jsampler = lambda x, y: jsoa.patch_sample_hn(vT, p.x0, p.y0, jg.origin, jg.hscale, x, y)
    jprm_d = dict(kp_scale=jprm.kp_scale.T, kd_scale=jprm.kd_scale.T, friction=jprm.friction,
                  added_mass=jprm.added_base_mass,
                  com_shift=tuple(jprm.base_com_shift.T))
    jsd = jsoa.SoAState(js.base_pos.T, js.base_quat.T, js.dof_pos.T, js.u.T)
    with jax.disable_jit():
        ref = jsoa.substep(JMC_, cfg_j, jsd, jctl.target.T, jctl.kp.T, jctl.kd.T, jprm_d,
                           jsampler, lam0=jnp.asarray(lam0))
    for a, b, atol in zip(got[0], ref[0], (1e-6, 1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=1e-5)   # impulses
    assert float(torch.as_tensor(lam0).abs().max()) > 0.05
