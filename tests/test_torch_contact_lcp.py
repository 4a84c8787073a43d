"""K1, the contact LCP solve: the port's plain version (contact_lcp_reference)
against both JAX solvers it replaces, plus the wrapper's dispatch (the
kernel itself is tested on the card by tests/test_torch_cuda.py).

Inputs come from the port's own SoA code on a batch of 8 random Go2 states
over a rough grid (some spheres in contact), exactly as a substep builds
them.  Tolerances: same float32 iteration on both sides, differing in the
G·lam summation order (dense bmm vs the Pallas mul+reduce or the JAX
matrix-free J (M^-1 (J^T lam))): impulses agree to 2e-6 on a ~0.3 scale.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.physics import soa as jsoa
from agility_tpu_torch.kernels import contact_lcp as k1
from agility_tpu_torch.physics import soa as tsoa
from torch_cases import CFG, N, S, contact_case, k1_args


def _planar(x):
    """(N, 3S) contact-interleaved [3s + a] -> the Pallas kernel's planar [a S + s]."""
    return x.view(N, S, 3).transpose(1, 2).reshape(N, 3 * S)


def test_reference_cold_matches_pallas_kernel(monkeypatch):
    """lam0 = 0 against pallas_contact.solve, in interpret mode on the CPU
    (as tests/test_pallas_contact.py runs it)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    from agility_tpu.physics import pallas_contact as pc

    G, vf, bias, n, act, dinv, mu, lam0 = k1_args(contact_case())
    assert int(act.sum()) > 0 and not lam0.any()
    ref = k1.contact_lcp_reference(G, vf, bias, n, act, dinv, mu, lam0, iters=10, relax=0.6)
    Gp = G.view(N, S, 3, S, 3).permute(0, 2, 1, 4, 3).reshape(N, 3 * S, 3 * S)
    dp = dinv.transpose(1, 2).reshape(N, 9 * S)
    j = lambda t: jnp.asarray(t.numpy())
    lam_p = pc.solve(j(Gp), j(_planar(vf)), j(_planar(bias)), j(_planar(n)), j(act), j(dp),
                     j(mu), S=S, iters=10, relax=0.6, env_block=8)
    got = np.asarray(lam_p).reshape(N, 3, S).transpose(0, 2, 1).reshape(N, 3 * S)
    assert np.abs(got).max() > 0.05                          # contacts carry impulse
    np.testing.assert_allclose(ref.numpy(), got, atol=2e-6)


def _to_jax(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    return x


def test_reference_warm_matches_soa_jacobi_solve():
    """lam0 != 0 against the served path's matrix-free soa.jacobi_solve,
    both fed the same substep quantities (phi, n, r, lever, mass factors,
    u_free) and the same carried impulses."""
    pre = contact_case(seed=1)
    rng = np.random.default_rng(2)
    lam0 = np.abs(rng.normal(0, 0.05, (3, S, N))).astype(np.float32)
    args = k1_args(pre, torch.as_tensor(lam0))
    assert float(args[7].abs().max()) > 0.05 and int(args[4].sum()) > 0
    ref = k1.contact_lcp_reference(*args, iters=5, relax=0.6)
    jp = _to_jax(pre)
    with jax.disable_jit():
        u_j, force_j, lam_j = jsoa.jacobi_solve(
            jp["phi"], jp["n"], jp["r"], jp["lever"], jp["f"], jp["u_free"], jp["mu"],
            CFG.dt, iters=5, relax=0.6, baumgarte=CFG.baumgarte, slop=CFG.contact_slop,
            max_depen_vel=CFG.max_depenetration_vel, restitution=CFG.restitution,
            lam0=jnp.asarray(lam0))
    lam_j = np.asarray(lam_j).transpose(2, 1, 0).reshape(N, 3 * S)
    np.testing.assert_allclose(ref.numpy(), lam_j, atol=2e-6)
    # and the port's full solve returns what soa.jacobi_solve returns
    u_t, force_t, lam_t = tsoa.jacobi_solve(
        pre["phi"], pre["n"], pre["r"], pre["lever"], pre["f"], pre["u_free"], pre["mu"],
        CFG.dt, iters=5, relax=0.6, lam0=torch.as_tensor(lam0), **tsoa.contact_kwargs(CFG))
    np.testing.assert_allclose(torch.stack(u_t).numpy(), np.stack(u_j), atol=1e-4)
    np.testing.assert_allclose(force_t.numpy(), np.asarray(force_j), atol=1e-3)


def test_wrapper_dispatch_and_layout():
    """CPU tensors take the plain version (no launch counted); the inputs a
    substep builds are what the kernel's checks accept; a device with no
    kernel raises instead of falling back."""
    args = k1_args(contact_case(), None)
    shapes = [(N, 3 * S, 3 * S), (N, 3 * S), (N, 3 * S), (N, 3 * S), (N, S), (N, S, 9),
              (N, S), (N, 3 * S)]
    for t, shp in zip(args, shapes):
        assert tuple(t.shape) == shp and t.dtype == torch.float32 and t.is_contiguous()
    before = k1.contact_lcp.launches
    got = k1.contact_lcp(*args, iters=5, relax=0.6)
    assert k1.contact_lcp.launches == before
    torch.testing.assert_close(got, k1.contact_lcp_reference(*args, iters=5, relax=0.6),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        k1.contact_lcp(*(t.to("meta") for t in args), iters=5, relax=0.6)


@pytest.mark.parametrize("s", range(1, k1.MAX_CONTACTS + 1))
def test_launch_config_layout(s):
    """The kernel's launch parameters at every S the wrapper takes: shared
    memory within a block's 227 KB; a row stride of whole float4 chunks, at
    most 3 per lane of a contact, where a contact's 8 lanes (a quarter-warp)
    reading chunks q + 8k of one row hit 8 disjoint bank groups; whole warps
    with 8 lanes for every contact; a persistent grid of 1 .. N blocks;
    16-byte copies only where every per-env segment is 16-byte aligned."""
    M = 3 * s
    for n, sms, per_sm in ((1, 132, 4), (7, 132, 4), (8, 132, 3), (1000, 132, 4),
                           (4096, 132, 4), (6144, 132, 3), (5, 1, 1)):
        cfg = k1.launch_config(n, s, sms, per_sm)
        assert 1 <= cfg["grid"] <= n and cfg["grid"] == min(n, sms * per_sm)
    ld, threads, smem = cfg["ld"], cfg["threads"], cfg["smem"]
    lanes = k1.LANES_PER_CONTACT
    assert smem <= k1.MAX_SMEM == 232_448
    assert ld >= M and ld % 4 == 0 and ld - M < 4
    chunks = ld // 4
    assert -(-chunks // lanes) <= 3                    # the kernel holds 3 chunks a row
    for r in range(M):
        for k in range(-(-chunks // lanes)):
            groups = {(r * ld // 4 + q + lanes * k) % 8 for q in range(lanes)
                      if q + lanes * k < chunks}
            assert len(groups) == min(lanes, chunks - lanes * k)
    assert threads % 32 == 0 and lanes * s <= threads < lanes * s + 32
    # two ring stages (G in rows of ld, then the vectors), lam and G lam, two
    # 8-byte barriers
    assert smem >= 4 * (2 * (M * ld + 4 * M + 2 * s + 9 * s) + 2 * ld) + 16
    assert smem % 16 == 0
    assert cfg["vec"] == (4 if s % 4 == 0 else 1)
    if cfg["vec"] == 4:          # bulk copies: G unpadded, every segment 16-byte multiples
        assert ld == M and all(4 * x % 16 == 0 for x in (M * M, M, s, 9 * s))


def test_launch_config_refuses_too_much_shared_memory():
    assert k1.launch_config(4096, 32, 132, 2)["smem"] == 80_400
    with pytest.raises(ValueError, match="shared memory"):
        k1.launch_config(4096, 64, 132, 1)
