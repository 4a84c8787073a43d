"""The port's per-env engine modules vs the JAX package's, function by function.

The same numpy batch goes through each JAX function (vmapped over envs, as
its engine runs it) and the port's batched counterpart: the heightfield
queries the engine adds, kinematics, dynamics, contact detection and the
three contact-frame solvers, the world-frame fast path, K1's per-env route
(its plain version on CPU tensors; the JAX side its Pallas kernel in
interpret mode), the state helpers and the dispatch of `step_batch`.
tests/test_torch_env.py holds the env step with `sim.solver="soft"`.

Tolerances: the functions evaluate the same float32 formulas, differing in
summation order and in a few fused products, so geometry and Jacobians hold
to 1e-5, matrices and factors to 1e-4 relative, solver outputs to 1e-4 in u
(velocities of O(1) m/s after impulses of O(1) N s); contact forces are
impulses / dt, several hundred N, held at 2e-2 N.  Whole control steps
are compared in tests/test_torch_physics_pervenv.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_engine_cases as cases
from torch_engine_cases import GRAV, N, close
from agility_tpu.physics import contact as jct
from agility_tpu.physics import dynamics as jdyn
from agility_tpu.physics import engine as jeng
from agility_tpu.physics import fastpath as jfp
from agility_tpu.physics import heightfield as jhf
from agility_tpu.physics import kinematics as jkin
from agility_tpu.physics import patch as jpt
from agility_tpu.physics import soa as jsoa
from agility_tpu.physics import state as jstate
from agility_tpu_torch.kernels import contact_lcp as k1
from agility_tpu_torch.physics import contact as tct
from agility_tpu_torch.physics import dynamics as tdyn
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import fastpath as tfp
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import kinematics as tkin
from agility_tpu_torch.physics import patch as tpt
from agility_tpu_torch.physics import soa as tsoa
from agility_tpu_torch.physics import state as tstate

JM, TM = cases.consts()


def jjv(fn):
    """The JAX side: fn vmapped over the env axis and jitted (its eager
    dispatch of many small ops is slower than the compile)."""
    return jax.jit(jax.vmap(fn))


def _links(rng, state=None, params=None):
    """Link states of a random batch on both sides: (jls, jaxes, tls, taxes,
    jax inputs, torch inputs); with `params` the per-env payload and CoM
    shift enter the model (engine._env_consts)."""
    state = state or cases.np_state(rng)
    j = [jnp.asarray(np.float32(x)) for x in state]
    t = [torch.as_tensor(np.float32(x)) for x in state]

    def jside(bp, bq, q, u, *prm):
        mc = jeng._env_consts(JM, jeng.EnvParams(*prm)) if prm else JM
        ls = jkin.velocities(mc, jkin.fk(mc, bp, bq, q), u[:3], u[3:6], u[6:])
        return ls, jkin.world_axes(mc, ls)

    jp = [jnp.asarray(np.float32(x)) for x in params] if params else []
    jls, jax_ = jjv(jside)(*j, *jp)
    mc = teng._env_consts(TM, teng.EnvParams(*[torch.as_tensor(np.float32(x))
                                               for x in params])) if params else TM
    tls = tkin.fk(mc, *t[:3])
    tls = tkin.velocities(mc, tls, t[3][:, :3], t[3][:, 3:6], t[3][:, 6:])
    return jls, jax_, tls, tkin.world_axes(mc, tls), j, t


def test_kinematics_match(rng):
    jls, jax_, tls, tax, _, _ = _links(rng)
    close(tuple(tls), tuple(jls), msg="LinkState")
    close(tax, jax_, msg="world_axes")
    pt = jls.pos[:, 7] + 0.05
    ref = jjv(lambda ls, a, p: jkin.point_jacobian(JM, ls, a, 7, p))(jls, jax_, pt)
    close(tkin.point_jacobian(TM, tls, tax, 7, torch.as_tensor(np.asarray(pt))), ref,
          msg="point_jacobian")
    close(tkin.com_jacobians(TM, tls, tax),
          jjv(lambda ls, a: jkin.com_jacobians(JM, ls, a))(jls, jax_), msg="com_jacobians")
    sl = JM.sph_link
    jc, jv = jjv(lambda ls: jkin.sphere_centers(JM, ls))(jls)
    close(tkin.sphere_centers(TM, tls), (jc, jv), msg="sphere_centers")
    close(tkin.points_jacobian(TM, tls, tax, sl, torch.as_tensor(np.asarray(jc))),
          jjv(lambda ls, a, c: jkin.points_jacobian(JM, ls, a, sl, c))(jls, jax_, jc),
          msg="points_jacobian")
    close(tkin.body_states(TM, tls), jjv(lambda ls: jkin.body_states(JM, ls))(jls),
          msg="body_states")


def test_dynamics_match(rng):
    """M, C and the structured solve with each env's payload and CoM shift."""
    _, _, prm = cases.np_step_inputs(rng)
    state = cases.np_state(rng)
    jls, jax_, tls, tax, j, t = _links(rng, state, prm)
    jprm = jeng.EnvParams(*[jnp.asarray(np.float32(x)) for x in prm])
    tmc = teng._env_consts(TM, teng.EnvParams(*[torch.as_tensor(np.float32(x)) for x in prm]))
    rhs = np.float32(rng.normal(0, 1.0, (N, 18, 5)))

    def jside(ls, a, u, p, r):
        mc = jeng._env_consts(JM, p)
        M = jdyn.mass_matrix(mc, ls, a)
        f = jdyn.factor_mass_matrix(M)
        return (jdyn.world_inertia(mc, ls), M,
                jdyn.bias_forces(mc, ls, a, u[6:], jnp.asarray(GRAV)), f,
                jdyn.solve_mass(f, r[:, 0]), jdyn.solve_mass(f, r))

    Iw, M, C, f, x1, x5 = jjv(jside)(jls, jax_, j[3], jprm, jnp.asarray(rhs))
    tM = tdyn.mass_matrix(tmc, tls, tax)
    tf = tdyn.factor_mass_matrix(tM)
    close(tdyn.world_inertia(tmc, tls), Iw, msg="world_inertia")
    close(tM, M, rtol=1e-5, atol=1e-5, msg="M")
    close(tdyn.bias_forces(tmc, tls, tax, t[3][:, 6:], GRAV), C, atol=1e-4, msg="C")
    close(tuple(tf), tuple(f), rtol=1e-4, atol=1e-4, msg="MassFactors")
    close(tdyn.solve_mass(tf, torch.as_tensor(rhs[..., 0])), x1, rtol=1e-4, atol=1e-4)
    close(tdyn.solve_mass(tf, torch.as_tensor(rhs)), x5, rtol=1e-4, atol=1e-4)


def test_limit_impulses_match(rng):
    """Joints at and past their limits, with velocities past the box."""
    state = cases.np_state(rng, spread=0.0)
    lo, hi = np.asarray(JM.dof_limit_lower), np.asarray(JM.dof_limit_upper)
    state[2] = np.where(rng.uniform(size=(N, 12)) < 0.5, lo + 0.01, hi - 0.01)
    state[2][:, ::4] = hi[::4] + 0.02                      # a few already outside
    state[3][:, 6:] = rng.normal(0, 8.0, (N, 12))
    jls, jax_, tls, tax, j, t = _links(rng, state)

    def jside(ls, a, u, q):
        f = jdyn.factor_mass_matrix(jdyn.mass_matrix(JM, ls, a))
        return jdyn.limit_impulses(JM, f, u, q, 0.005)

    ref = jjv(jside)(jls, jax_, j[3], j[2])
    got = tdyn.limit_impulses(TM, tdyn.factor_mass_matrix(tdyn.mass_matrix(TM, tls, tax)),
                              t[3], t[2], 0.005)
    close(got, ref, rtol=1e-4, atol=1e-4)
    assert float((got - t[3])[:, 6:].abs().max()) > 1.0     # joints were pushed back


@pytest.fixture(scope="module")
def layered():
    """A layered grid (movable layers and the seesaw lever) and its weights."""
    rng = np.random.default_rng(5)
    state, ctl, prm = cases.np_step_inputs(rng, weights=True)
    jg, tg = cases.grids(cases.np_grid(rng, layered=True))
    return jg, tg, state, ctl, prm


def test_heightfield_queries_match(layered, rng):
    jg, tg, _, _, prm = layered
    x = np.float32(rng.uniform(-1.5, 1.4, (N, 6)))
    y = np.float32(rng.uniform(-1.3, 1.2, (N, 6)))
    w = np.float32(prm[5])
    jx, jy, jw = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
    tx, ty, tw = torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w)
    close(thf.sample_lever(tg, tx, ty), jhf.sample_lever(jg, jx, jy), atol=1e-6)
    np.testing.assert_array_equal(thf.on_lever(tg, tx, ty).numpy(),
                                  np.asarray(jhf.on_lever(jg, jx, jy)))
    assert thf.on_lever(tg, tx, ty).any() and not thf.on_lever(tg, tx, ty).all()
    vj = jjv(lambda a, b, c: jhf.sample_height_nearest(jg, a, b, c))
    close(thf.sample_height_nearest(tg, tx, ty, tw), vj(jx, jy, jw), atol=1e-6)
    close(thf.sample_height_nearest(tg, tx, ty), jhf.sample_height_nearest(jg, jx, jy),
          atol=1e-6)
    vn = jjv(lambda a, b, c: jhf.sample_normal(jg, a, b, c))
    close(thf.sample_normal(tg, tx, ty, tw), vn(jx, jy, jw), atol=2e-5, msg="normal, weights")
    fj, ft = jhf.flat_grid(0.5), thf.flat_grid(0.5, device="cpu")
    close(ft.height, fj.height, atol=0)
    assert ft.hscale == fj.hscale and ft.origin == tuple(np.asarray(fj.origin).tolist())


def _solver_inputs(layered):
    """Link states, mass factors and u_free on the layered grid, both sides."""
    jg, tg, state, ctl, prm = layered
    jls, jax_, tls, tax, j, t = _links(None, state)
    jf = jjv(lambda ls, a: jdyn.factor_mass_matrix(jdyn.mass_matrix(JM, ls, a)))(jls, jax_)
    tf = tdyn.factor_mass_matrix(tdyn.mass_matrix(TM, tls, tax))
    return jls, jax_, tls, tax, j, t, jf, tf


def test_contact_frame_solvers_match(layered):
    """detect (with per-env weights), pgs_solve, jacobi_solve, soft_forces."""
    jg, tg, _, _, prm = layered
    jls, jax_, tls, tax, j, t, jf, tf = _solver_inputs(layered)
    w, mu = np.float32(prm[5]), np.float32(prm[0])
    jcon = jjv(lambda ls, a, ww: jct.detect(JM, ls, a, jg, ww))(jls, jax_, jnp.asarray(w))
    tcon = tct.detect(TM, tls, tax, tg, torch.as_tensor(w))
    close(tuple(tcon), tuple(jcon), atol=2e-5, msg="Contacts")
    assert int((tcon.phi < 0).sum()) >= 4                  # contacts are active
    tmu = torch.as_tensor(mu)
    for name, kw in (("pgs_solve", dict(iters=4)), ("jacobi_solve", dict(iters=10, relax=0.6))):
        ref = jjv(lambda c, f, u, m: getattr(jct, name)(c, f, u, m, 0.005, **kw))(
            jcon, jf, j[3], jnp.asarray(mu))
        got = getattr(tct, name)(tcon, tf, t[3], tmu, 0.005, **kw)
        close(got[0], ref[0], atol=1e-4, msg=f"{name} u")
        close(got[1], ref[1], atol=1e-5, msg=f"{name} lam")
        close(got[2], ref[2], atol=2e-2, msg=f"{name} force")
    ref = jjv(lambda c, u, m: jct.soft_forces(c, u, m))(jcon, j[3], jnp.asarray(mu))
    close(tct.soft_forces(tcon, t[3], tmu), ref, rtol=1e-5, atol=2e-2, msg="soft_forces")


@pytest.mark.parametrize("where", ["window", "window_roof", "grid"])
def test_detect_T_matches(where):
    """detect_T from the K2 window (the JAX side its per-env patch), with the
    ceiling rows on a roofed grid, and from direct grid queries."""
    rng = np.random.default_rng(9)
    state, _, prm = cases.np_step_inputs(rng, weights=True)
    jg, tg = cases.grids(cases.np_grid(rng, layered=True, roof=where == "window_roof"))
    jls, jax_, tls, tax, j, t = _links(None, state)
    w = np.float32(prm[5])
    size = 24 if where != "grid" else 0

    def jside(ls, a, bp, ww):
        p = jpt.extract(jg, bp[:2], size, ww) if size else None
        return jfp.detect_T(JM, ls, a, jg, ww, p)

    ref = jjv(jside)(jls, jax_, j[0], jnp.asarray(w))
    tw = torch.as_tensor(w)
    patch = tpt.extract_batch(tg, t[0][:, :2], size, tw) if size else None
    got = tfp.detect_T(TM, tls, tax, tg, tw, patch)
    close(got, ref, atol=2e-5)
    if where == "window_roof":
        assert got[0].shape[1] == TM.sph_link.shape[0] + 4
        assert int((got[0][:, -4:] < 0).sum()) > 0         # ceiling rows are active


def test_world_solvers_and_k1_route_match(layered, monkeypatch):
    """mass_and_bias, jacobi_solve_world (its sweeps through K1's plain
    version), soft_forces_world, and K1's per-env route against the JAX
    package's Pallas route (interpret mode)."""
    from jax.experimental import pallas as pl
    from agility_tpu.physics import pallas_contact as jpc

    jg, tg, _, _, prm = layered
    jls, jax_, tls, tax, j, t, _, _ = _solver_inputs(layered)
    w, mu = jnp.asarray(np.float32(prm[5])), np.float32(prm[0])
    tw, tmu = torch.as_tensor(np.float32(prm[5])), torch.as_tensor(mu)

    def jside(ls, a, u, ww, m):
        M, C = jfp.mass_and_bias(JM, ls, a, u[6:], jnp.asarray(GRAV))
        f = jdyn.factor_mass_matrix(M)
        phi, n, JpT = jfp.detect_T(JM, ls, a, jg, ww)
        u_free = u + 0.005 * jdyn.solve_mass(f, -C)
        MinvJT = jdyn.solve_mass(f, JpT)
        return ((M, C), (phi, n, JpT, u_free, MinvJT, JpT.T @ MinvJT),
                jfp.jacobi_solve_world(phi, n, JpT, f, u_free, m, 0.005, iters=10),
                jfp.soft_forces_world(phi, n, JpT, u, m))

    (jM, jC), jcon, jwj, jsoft = jjv(jside)(jls, jax_, j[3], w, jnp.asarray(mu))
    tM, tC = tfp.mass_and_bias(TM, tls, tax, t[3][:, 6:], GRAV)
    close((tM, tC), (jM, jC), rtol=1e-5, atol=1e-4, msg="mass_and_bias")
    tf = tdyn.factor_mass_matrix(tM)
    phi, n, JpT = tfp.detect_T(TM, tls, tax, tg, tw)
    u_free = t[3] + 0.005 * tdyn.solve_mass(tf, -tC)
    close((phi, n, JpT, u_free), jcon[:4], atol=2e-5, msg="detect_T, u_free")
    assert int((phi < 0).sum()) >= 4
    k1.contact_lcp.launches = 0
    got = tfp.jacobi_solve_world(phi, n, JpT, tf, u_free, tmu, 0.005, iters=10)
    close(got[0], jwj[0], atol=1e-4, msg="jacobi_solve_world u")
    close(got[1], jwj[1], atol=2e-2, msg="jacobi_solve_world force")
    close(tfp.soft_forces_world(phi, n, JpT, t[3], tmu), jsoft, rtol=1e-5, atol=2e-2,
          msg="soft_forces_world")
    assert k1.contact_lcp.launches == 0                     # CPU tensors: the plain version

    # K1's per-env route on the JAX side's own inputs, against its Pallas route
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    args = [np.asarray(x) for x in jcon]
    ref = jpc.jacobi_solve_batch(*[jnp.asarray(a) for a in args[:3]], jnp.asarray(args[4]),
                                 jnp.asarray(args[5]), jnp.asarray(args[3]), jnp.asarray(mu),
                                 0.005, iters=10, env_block=N)
    tt = [torch.as_tensor(a) for a in args]
    got = k1.jacobi_solve_batch(tt[0], tt[1], tt[2], tt[4], tt[5], tt[3], tmu, 0.005, iters=10)
    # the Pallas kernel's cone uses sqrt(|t|^2 + 1e-18), K1 max(|t|, 1e-9)
    close(got[0], ref[0], atol=1e-4, msg="K1 route u")
    close(got[1], ref[1], atol=2e-2, msg="K1 route force")


def test_state_helpers_match(rng):
    _, _, prm = cases.np_step_inputs(rng)
    jz = jstate.zero_state(N, 12, 17)
    tz = tstate.zero_state(N, 12, 17, device="cpu")
    assert tz._fields == jz._fields
    close(tuple(tz), tuple(jz), atol=0)
    close(tz.root_states, jz.root_states, atol=0)
    jn, tn = jeng.EnvParams.nominal(), teng.EnvParams.nominal(N, device="cpu")
    for k in ("friction", "kp_scale", "kd_scale", "added_base_mass", "base_com_shift"):
        close(getattr(tn, k), np.broadcast_to(np.asarray(getattr(jn, k)),
                                              (N,) + np.shape(getattr(jn, k))), atol=0, msg=k)
    state = cases.np_state(rng)
    j = jeng.EnvState(*[jnp.asarray(np.float32(x)) for x in state])
    t = teng.EnvState(*[torch.as_tensor(np.float32(x)) for x in state])
    close(teng.refresh_sim_state(TM, t), jjv(lambda s: jeng.refresh_sim_state(JM, s))(j),
          msg="refresh_sim_state")
    (_, jc, jp), (_, tc, tp) = cases.engine_inputs(state, *cases.np_step_inputs(rng)[1:])
    tau = jjv(lambda c, p, q, qd: jeng.pd_torques(JM, c, p, q, qd))(
        jc, jp, j.dof_pos, j.u[:, 6:])
    close(teng.pd_torques(TM, tc, tp, t.dof_pos, t.u[:, 6:]), tau, atol=1e-4, msg="pd_torques")


# (config, grid has a ceiling) -> the path step_batch takes, the JAX package's rule
DISPATCH = [
    (dict(), False), (dict(solver="pgs"), False), (dict(solver="soft"), False),
    (dict(soa=False), False), (dict(pallas_contact=True), False),
    (dict(fast=False, solver="pgs"), False), (dict(warm_start=True, jacobi_iters=5), False),
    (dict(solver="pgs", warm_start=True, jacobi_iters=5), False),
    (dict(solver="pgs"), True), (dict(solver="soft", fast=False), True),
    (dict(solver="pgs", patch_size=0), True), (dict(pallas_contact=True), True),
    (dict(soa=False, warm_start=True, jacobi_iters=5), True),
]


@pytest.mark.parametrize("kw,roof", DISPATCH)
def test_step_batch_dispatch_matches(kw, roof, monkeypatch):
    """Which path step_batch takes for each config (the SoA path iff soa,
    solver "jacobi" and no pallas_contact; a ceiling forces it unless the fast
    path has a window) and the config it hands on (warm start -> 2x cold
    sweeps off the SoA path), against the JAX package with AGILITY_ENGINE
    unset.  The port never reads AGILITY_ENGINE: setting it changes nothing."""
    monkeypatch.delenv("AGILITY_ENGINE", raising=False)
    jg, tg = cases.grids(cases.np_grid(np.random.default_rng(0), roof=roof))
    seen = {}

    def record(side, path):
        return lambda mc, cfg, *a: seen.setdefault(side, (path, cfg.warm_start,
                                                          cfg.jacobi_iters))

    monkeypatch.setattr(jsoa, "control_step_batched", record("jax", "soa"))
    monkeypatch.setattr(jeng, "control_step_batched", record("jax", "per_env"))
    monkeypatch.setattr(tsoa, "control_step_batched", record("port", "soa"))
    monkeypatch.setattr(teng, "control_step_batched", record("port", "per_env"))
    jeng.step_batch(JM, jeng.EngineConfig(**kw), jg, None, None, None)
    teng.step_batch(TM, teng.EngineConfig(**kw), tg, None, None, None)
    assert seen["port"] == seen["jax"]
    assert (seen["port"][0] == "soa") == teng.uses_soa(teng.EngineConfig(**kw), tg)
    monkeypatch.setenv("AGILITY_ENGINE", "vmap" if seen["port"][0] == "soa" else "soa")
    del seen["port"]
    teng.step_batch(TM, teng.EngineConfig(**kw), tg, None, None, None)
    assert seen["port"] == seen["jax"]
