"""The port's per-env control step vs the JAX package's, engine variant by
engine variant, over 3 control steps.

Each variant of `EngineConfig` that selects the per-env path — the
world-frame Jacobi solve (solver "jacobi" with soa=False, and "pgs", which
the fast path solves the same way; its sweeps in K1's plain version here),
projected Gauss-Seidel and Jacobi in contact frames (fast=False), soft
contacts on either path, direct grid queries (patch_size=0), pallas_contact,
and the fast path's ceiling rows on a roofed grid — goes through
`engine.step_batch` on both sides from one numpy batch (randomized
parameters, per-env heightfield weights), 3 control steps of 4 substeps.
The JAX side jits its step_batch with AGILITY_ENGINE unset, so its own
config selects the path; pallas_contact runs its Pallas kernel in interpret
mode, as tests/test_pallas_engine.py does.

Both sides run in float64.  In float32 the soft model amplifies rounding
through its stiff explicit penalty forces, so after 3 control steps the
port parts from itself in float64 about as far as from the JAX package,
by more than tests/test_soa.py's u tolerance.  In float64 the batch
agrees to ~1e-10, so the states are held at 1e-8 (u 1e-6) and the body
forces at 1e-5 N; tests/test_torch_engine.py holds the float32 functions,
tests/test_torch_env.py the float32 soft env step.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import torch_engine_cases as cases
from agility_tpu.physics import engine as jeng
from agility_tpu_torch.kernels import contact_lcp as k1
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import patch as tpt

F64 = np.float64
VARIANTS = {
    "jacobi_fast_warm_to_cold": dict(soa=False, warm_start=True, jacobi_iters=5),
    "pgs_fast": dict(solver="pgs"),
    "pgs_contact_frames": dict(solver="pgs", fast=False),
    "jacobi_contact_frames": dict(solver="jacobi", fast=False, soa=False),
    "soft_fast": dict(solver="soft"),
    "soft_contact_frames": dict(solver="soft", fast=False),
    "grid_direct": dict(soa=False, patch_size=0),
    "pallas_contact": dict(pallas_contact=True, pallas_env_block=cases.N),
    "pgs_fast_ceiling": dict(solver="pgs"),
}
STATE_TOL = dict(base_pos=1e-8, base_quat=1e-8, dof_pos=1e-8, u=1e-6)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    state, ctl, prm = cases.np_step_inputs(rng, weights=True)
    g = cases.np_grid(rng, layered=True), cases.np_grid(rng, layered=True, roof=True)
    with jax.enable_x64(True):
        JM, TM = cases.consts(F64)
        grids = [cases.grids(x, F64) for x in g]
        (js, jc, jp), (ts, tc, tp) = cases.engine_inputs(state, ctl, prm, F64)
    return JM, TM, grids, (js, jc, jp), (ts, tc, tp)


def _jax_steps(JM, cfg, grid, s, ctl, prm, steps):
    step = jax.jit(lambda s: jeng.step_batch(JM, cfg, grid, s, ctl, prm))
    out = []
    for _ in range(steps):
        r = step(s)
        s = r[0]
        out.append(r)
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_control_step_matches(setup, name, monkeypatch):
    JM, TM, grids, (js, jc, jp), (ts, tc, tp) = setup
    kw = VARIANTS[name]
    (jg, tg) = grids[1] if name.endswith("ceiling") else grids[0]
    monkeypatch.delenv("AGILITY_ENGINE", raising=False)
    if kw.get("pallas_contact"):
        from jax.experimental import pallas as pl

        orig = pl.pallas_call
        monkeypatch.setattr(pl, "pallas_call",
                            lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    tcfg = teng.EngineConfig(**kw)
    assert not teng.uses_soa(tcfg, tg)
    with jax.enable_x64(True):
        ref = _jax_steps(JM, jeng.EngineConfig(dtype=jnp.float64, **kw), jg, js, jc, jp, 3)
    k1.contact_lcp.launches = 0
    s = ts
    for i, r in enumerate(ref):
        s, taus, bf, mbf, patch = teng.step_batch(TM, tcfg, tg, s, tc, tp)
        rs, rtaus, rbf, rmbf, _ = r
        for k, atol in STATE_TOL.items():
            np.testing.assert_allclose(getattr(s, k).numpy(), np.asarray(getattr(rs, k)),
                                       rtol=0, atol=atol, err_msg=f"step {i} {k}")
        for a, b in zip(taus, rtaus):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        np.testing.assert_allclose(bf.numpy(), np.asarray(rbf), rtol=0, atol=1e-5)
        np.testing.assert_allclose(mbf.numpy(), np.asarray(rmbf), rtol=0, atol=1e-5)
        assert (patch is None) == (not (tcfg.fast and tcfg.patch_size))
    assert float(mbf.abs().max()) > 10.0                   # contacts were active
    assert k1.contact_lcp.launches == 0                    # CPU tensors: K1's plain version
    if name.endswith("ceiling"):
        # the trunk presses into the roof: ceiling rows past the S sphere rows
        patch = tpt.extract_batch(tg, ts.base_pos[:, :2], tcfg.patch_size, tp.hf_weights)
        p = teng._pre_contact(TM, tcfg, tg, ts, tc, tp, patch)
        assert int((p.phi[:, TM.sph_link.shape[0]:] < 0).sum()) > 0
