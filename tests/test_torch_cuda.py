"""The port's CUDA kernels on the card, against their plain-torch versions.

Runs only where torch sees a CUDA card; elsewhere each test skips.  Imports
no jax, so on the card machine (no jax installed) run it without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from agility_tpu_torch.kernels import contact_lcp as k1
from agility_tpu_torch.kernels import launch_counts
from agility_tpu_torch.kernels import free_dynamics as kfd
from agility_tpu_torch.kernels import scandots as k3
from agility_tpu_torch.kernels import terrain_window as k2
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import graphs
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.physics import soa as tsoa
from torch_cases import (N, S, batch_case, contact_case, k1_args, layered_case, model_consts,
                         random_contact_problem, window_case)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel builds and runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
def test_contact_lcp_kernel_matches_reference(card):
    """K1 against its plain version, cold and warm-started (chip_smoke.py
    repeats this at N = 4096).  Tolerance: float32 sums in another order,
    1e-4 of the impulse scale."""
    pre = contact_case(device="cuda")
    for lam0, iters in ((None, 10), (torch.full((3, S, N), 0.02, device="cuda"), 5)):
        args = k1_args(pre, lam0)
        before = k1.contact_lcp.launches
        out = k1.contact_lcp(*args, iters=iters, relax=0.6)
        torch.cuda.synchronize()
        assert k1.contact_lcp.launches == before + 1
        ref = k1.contact_lcp_reference(*args, iters=iters, relax=0.6)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 1000])
@pytest.mark.parametrize("s", [1, 5, 24, 28, 32])
def test_contact_lcp_kernel_edge_shapes(card, n, s):
    """K1 against its plain version where the persistent grid is larger than
    N (1, 7, 8) or does not divide it (1000), at both copy widths (S % 4 != 0
    takes 4-byte copies) up to the largest shared memory (S = 32), warm
    (5 sweeps from lam0 > 0) and cold (10 from zero); two calls give the same
    bits (one block per env, no atomics)."""
    for warm, iters in ((True, 5), (False, 10)):
        args = [torch.as_tensor(a, device="cuda")
                for a in random_contact_problem(n, s, seed=n + s, warm=warm)]
        out = k1.contact_lcp(*args, iters=iters, relax=0.6)
        again = k1.contact_lcp(*args, iters=iters, relax=0.6)
        ref = k1.contact_lcp_reference(*args, iters=iters, relax=0.6)
        torch.cuda.synchronize()
        assert float(ref.abs().max()) > 0.1                   # contacts carry impulse
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
        assert torch.equal(out, again)


@pytest.mark.cuda
def test_control_step_on_card_matches_cpu(card):
    """A warm-started control step (4 substeps, K1 on the card) against the
    same step on the CPU (plain version), at tests/test_soa.py's tolerances."""
    cfg = teng.EngineConfig(warm_start=True, jacobi_iters=5)
    outs = {}
    for dev in ("cuda", "cpu"):
        s, ctl, prm, grid = batch_case(device=dev)
        before = k1.contact_lcp.launches
        outs[dev] = tsoa.control_step_batched(model_consts(dev), cfg, grid, s, ctl, prm)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert k1.contact_lcp.launches == before + cfg.decimation
    (g, _, gbf, _, _), (c, _, cbf, _, _) = outs["cuda"], outs["cpu"]
    for k, atol in dict(base_pos=5e-4, base_quat=5e-4, dof_pos=1e-3, u=3e-2).items():
        torch.testing.assert_close(getattr(g, k).cpu(), getattr(c, k), rtol=0, atol=atol)
    assert float(cbf.abs().max()) > 1.0                   # contacts were active


def _graph_grid(ceiling):
    """A rough 10 x 10 m grid on the card; with `ceiling` a 0.45 m roof over
    its middle 4 x 4 m."""
    rng = np.random.default_rng(7)
    ceil = None
    if ceiling:
        ceil = np.full((200, 200), thf.NO_CEILING, np.float32)
        ceil[60:140, 60:140] = 0.45
    return thf.from_numpy(0.03 * rng.normal(size=(200, 200)), 0.05, (-5.0, -5.0), "cuda",
                          ceiling=ceil)


def _graph_batch(n, seed):
    """A new (EnvState, Control, EnvParams) of n envs low over _graph_grid,
    every randomisation on, each tensor new."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda")
    dof0 = model_consts().default_dof_pos.numpy()
    q = rng.normal(0, 0.1, (n, 4)) + np.array([0, 0, 0, 1.0])
    s = teng.EnvState(f32(np.c_[rng.uniform(-3, 3, (n, 2)), np.full(n, 0.3)]),
                      f32(q / np.linalg.norm(q, axis=-1, keepdims=True)),
                      f32(dof0 + rng.uniform(-0.3, 0.3, (n, 12))), f32(rng.normal(0, 0.3, (n, 18))))
    ctl = teng.Control(f32(dof0 + rng.uniform(-0.2, 0.2, (n, 12))), f32(np.full((n, 12), 40.0)),
                       f32(np.full((n, 12), 1.0)))
    prm = teng.EnvParams(f32(rng.uniform(0.6, 1.2, n)), f32(rng.uniform(0.9, 1.1, (n, 12))),
                         f32(rng.uniform(0.9, 1.1, (n, 12))), f32(rng.uniform(-1.0, 2.0, n)),
                         f32(rng.normal(0, 0.02, (n, 3))))
    return s, ctl, prm


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _graph_counts():
    return [(g.captures, g.replays) for g in (tsoa.FREE_DYNAMICS, tsoa.CONTACT_APPLY)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, P, ceiling, params", [(4096, 24, False, True),
                                                   (4096, 24, False, False),
                                                   (6144, 32, True, True),
                                                   (4096, 32, True, True)])
def test_free_dynamics_kernel_matches_pre_contact(card, n, P, ceiling, params):
    """The free-dynamics kernel against plain pre_contact on the same CUDA
    inputs, every output field bit for bit: the BBC's shape (N 4096, S 24,
    P 24) with and without added_mass and com_shift, the TSC's with the
    ceiling rows (N 6144, S' 28, P 32) and the depth student's TSC env (N
    4096, S' 28, P 32: cuBLAS picks its sums by shape); 3 control steps of new states, each
    carried a substep.  Bit for bit because the kernel rounds each product
    and sum as PyTorch's elementwise kernels do (no FMA contraction) and
    sums the window's cells as cuBLAS does: a rounding gap would move a
    sphere across a window cell's edge now and then, whose normal jumps
    there (measured on an H100: equal at both shapes).  Two launches give
    the same bits; one launch a call."""
    mc, cfg, grid = model_consts("cuda"), teng.EngineConfig(patch_size=P), _graph_grid(ceiling)
    for step in range(3):
        s, ctl, prm = _graph_batch(n, seed=10 + step)
        sd, (target, kp, kd, p, smp, csmp), _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
        if not params:
            p = dict(kp_scale=p["kp_scale"], kd_scale=p["kd_scale"], friction=p["friction"])
        before = kfd.free_dynamics.launches
        got = kfd.free_dynamics(mc, cfg, sd, target, kp, kd, p, smp, csmp)
        again = kfd.free_dynamics(mc, cfg, sd, target, kp, kd, p, smp, csmp)
        want = tsoa.pre_contact(mc, cfg, sd, target, kp, kd, p, smp, csmp)
        torch.cuda.synchronize()
        assert kfd.free_dynamics.launches == before + 2
        assert got["phi"].shape == (28 if ceiling else 24, n)
        assert got["f"]["legs"] == want["f"]["legs"]
        assert sorted(got) == sorted(want)
        for k in sorted(want):
            for a, b in zip(_tensors(got[k]), _tensors(want[k]), strict=True):
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b), (k, int((a != b).reshape(-1, n).any(0).sum()))
        for a, b in zip(_tensors(got), _tensors(again), strict=True):
            assert torch.equal(a, b)
        assert float((want["phi"] < 0).float().mean()) > 0.01      # contacts present
        if ceiling:
            assert bool((want["phi"][24:] < 0).any())                # ceiling rows active


@pytest.mark.cuda
@pytest.mark.parametrize("n, P, ceiling", [(4096, 24, False), (6144, 32, True)])
def test_free_dynamics_graph_is_bit_equal(card, n, P, ceiling):
    """Stage A's graph (the free-dynamics kernel and K1's inputs,
    FREE_DYNAMICS) replayed against soa.stage_a called directly on the same
    inputs (the same kernel, eager), bit for bit, at the BBC's shape (N
    4096, S 24, P 24) and the TSC's with the ceiling rows (N 6144, S 28, P
    32): 3 control steps of 4 substeps, each step with new state, params
    and K2 window tensors (a stale pointer would show), the state carried
    by K1, the apply and the integration, called directly.  One capture, 12
    replays; the wrapper called twice by the capture (its warm-up and the
    capture) and once a direct call, never by a replay; the kernel launched
    on the device at the warm-up, each direct call and each replay
    (kernels.launch_counts)."""
    mc, cfg, grid = model_consts("cuda"), teng.EngineConfig(patch_size=P), _graph_grid(ceiling)
    cache = tsoa.FREE_DYNAMICS
    before = cache.captures, cache.replays
    launches, eager = kfd.free_dynamics.launches, kfd.free_dynamics.eager
    on_card = launch_counts()["free_dynamics"]
    for step in range(3):
        s, ctl, prm = _graph_batch(n, seed=step)
        sd, (target, kp, kd, p, smp, csmp), _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
        assert (csmp is not None) == ceiling
        for _ in range(cfg.decimation):
            inputs, samplers = (sd, target, kp, kd, p), (smp, csmp)
            got = cache(graphs.key((inputs, samplers), id(mc), cfg), mc,
                        lambda a, h: tsoa.stage_a(mc, cfg, *a, *h), inputs, samplers)
            want = tsoa.stage_a(mc, cfg, sd, target, kp, kd, p, smp, csmp)
            assert want["phi"].shape[0] == (28 if ceiling else 24)
            for a, b in zip(_tensors(got), _tensors(want), strict=True):
                assert torch.equal(a, b)
            lam = tsoa.contact_lcp(*want["problem"], iters=cfg.jacobi_iters,
                                   relax=cfg.jacobi_relax)
            u_new, _, _ = tsoa.apply_impulses(lam, want["r"], want["lever"], want["f"],
                                              want["u_free"], cfg.dt)
            sd = tsoa.integrate(mc.soa, cfg, sd, want["f"], u_new)
    torch.cuda.synchronize()
    assert (cache.captures - before[0], cache.replays - before[1]) == (1, 12)
    assert kfd.free_dynamics.launches - launches == 2 + 12
    assert kfd.free_dynamics.eager - eager == 1 + 12
    assert launch_counts()["free_dynamics"] - on_card == 1 + 12 + 12


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("n, P, ceiling", [(4096, 24, False), (6144, 32, True)])
def test_substep_graphs_are_bit_equal(card, monkeypatch, n, P, ceiling, warm):
    """The substep on the card (stage A's graph, K1 eager, stage B's graph)
    against its stage functions called directly, stage_a (the free-dynamics
    kernel, eager) -> jacobi_solve -> integrate, on the same inputs, bit for bit: state, tau,
    tau_org, force and lam, at the BBC's shape and the TSC's with the
    ceiling rows, over 3 control steps of 4 substeps, each step with new state, params and K2 window tensors, the
    state carried by the graphs' outputs, and with `warm` each substep after
    the first warm-started from the last one's lam (the tasks' sim
    warm_start).  Each cache takes one capture and 12 replays, warm or cold;
    K1 is called through `soa.contact_lcp` (the name the benchmark's
    K1Shapes wraps) once a substep, at (N, S')."""
    mc, cfg, grid = model_consts("cuda"), teng.EngineConfig(patch_size=P), _graph_grid(ceiling)
    rows = 28 if ceiling else 24
    shapes = []
    orig = tsoa.contact_lcp

    def counted(G, *a, **k):
        shapes.append((G.shape[0], G.shape[1] // 3))
        return orig(G, *a, **k)

    monkeypatch.setattr(tsoa, "contact_lcp", counted)
    before = _graph_counts()
    graphed_calls = 0
    for step in range(3):
        s, ctl, prm = _graph_batch(n, seed=step)
        sd, (target, kp, kd, p, smp, csmp), _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
        lam0 = None
        for _ in range(cfg.decimation):
            # the direct calls first: the substep overwrites sd, the previous one's output
            e = tsoa.stage_a(mc, cfg, sd, target, kp, kd, p, smp, csmp)
            u_new, force, lam = tsoa.jacobi_solve(
                e["phi"], e["n"], e["r"], e["lever"], e["f"], e["u_free"], p["friction"],
                cfg.dt, iters=cfg.jacobi_iters, relax=cfg.jacobi_relax, lam0=lam0,
                **tsoa.contact_kwargs(cfg))
            want = (tsoa.integrate(mc.soa, cfg, sd, e["f"], u_new),
                    (e["tau_j"], e["tau_org"]), force, lam)
            k = len(shapes)
            got = tsoa.substep(mc, cfg, sd, target, kp, kd, p, smp, csmp, lam0=lam0)
            graphed_calls += len(shapes) - k
            assert shapes[-1] == (n, rows)
            for a, b in zip(_tensors(got), _tensors(want), strict=True):
                assert torch.equal(a, b)
            sd = got[0]
            if warm:
                lam0 = got[3]
    torch.cuda.synchronize()
    assert graphed_calls == 12
    assert shapes == [(n, rows)] * 24                     # 12 eager, 12 graphed
    after = _graph_counts()
    for (c0, r0), (c1, r1) in zip(before, after):
        assert (c1 - c0, r1 - r0) == (1, 12)
    assert float(want[2].abs().max()) > 1.0               # contacts carry impulse


@pytest.mark.cuda
def test_control_step_keeps_its_torques(card):
    """tau and tau_org returned by a control step on the graph path are the
    step's own: unchanged after the next step, which replays the graphs that
    computed them."""
    mc, cfg, grid = model_consts("cuda"), teng.EngineConfig(), _graph_grid(False)
    before = _graph_counts()
    s, ctl, prm = _graph_batch(4096, seed=0)
    _, taus, _, _, _ = tsoa.control_step_batched(mc, cfg, grid, s, ctl, prm)
    kept = [t.clone() for t in taus]
    s2, ctl2, prm2 = _graph_batch(4096, seed=1)
    _, taus2, _, _, _ = tsoa.control_step_batched(mc, cfg, grid, s2, ctl2, prm2)
    torch.cuda.synchronize()
    for (_, r0), (_, r1) in zip(before, _graph_counts()):
        assert r1 - r0 == 2 * cfg.decimation
    assert not torch.equal(taus2[1], kept[1])
    for t, k in zip(taus, kept):
        assert torch.equal(t, k)


@pytest.mark.cuda
def test_control_step_keeps_its_state_and_forces(card):
    """The state, body_forces and max_body_forces returned by a control step
    on the graph path are the step's own: unchanged after the next step,
    whose graphs overwrite the outputs they were computed from."""
    mc, cfg, grid = model_consts("cuda"), teng.EngineConfig(), _graph_grid(False)
    s, ctl, prm = _graph_batch(4096, seed=0)
    state, _, bf, mbf, _ = tsoa.control_step_batched(mc, cfg, grid, s, ctl, prm)
    outs = [*state, bf, mbf]
    kept = [t.clone() for t in outs]
    s2, ctl2, prm2 = _graph_batch(4096, seed=1)
    state2, _, bf2, _, _ = tsoa.control_step_batched(mc, cfg, grid, s2, ctl2, prm2)
    torch.cuda.synchronize()
    assert not torch.equal(state2.base_pos, kept[0])
    assert not torch.equal(bf2, kept[4])
    assert float(kept[5].abs().max()) > 1.0               # contacts were active
    for t, k in zip(outs, kept):
        assert torch.equal(t, k)


@pytest.mark.cuda
def test_contact_lcp_per_env_route_matches_reference(card):
    """K1 through the per-env engine's route (contact_lcp.jacobi_solve_batch,
    inputs from engine._pre_contact on the card) against the same route on
    the CPU tensors' plain version; then a per-env control step (solver
    "pgs": the world-frame Jacobi solve, 2 x 5 cold sweeps) on the card
    against the CPU at tests/test_soa.py's tolerances, K1 launched once a
    substep."""
    from agility_tpu_torch.kernels.terrain_window import terrain_window
    from agility_tpu_torch.physics import dynamics as dyn

    s, ctl, prm, grid = batch_case(device="cuda")
    mc = model_consts("cuda")
    patch = terrain_window(grid, s.base_pos[:, :2].contiguous(), 24, None)
    p = teng._pre_contact(mc, teng.EngineConfig(), grid, s, ctl, prm, patch)
    MinvJT = dyn.solve_mass(p.factors, p.JpT)
    G = p.JpT.transpose(1, 2) @ MinvJT
    args = (p.phi, p.normals, p.JpT, MinvJT, G, p.u_free, prm.friction, 0.005)
    before = k1.contact_lcp.launches
    u, f = k1.jacobi_solve_batch(*args, iters=10)
    torch.cuda.synchronize()
    assert k1.contact_lcp.launches == before + 1
    ru, rf = k1.jacobi_solve_batch(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                                   iters=10)
    assert float(rf.abs().max()) > 1.0                   # contacts carry force
    torch.testing.assert_close(f.cpu(), rf, rtol=0, atol=1e-4 * float(rf.abs().max()))
    torch.testing.assert_close(u.cpu(), ru, rtol=0, atol=1e-4)

    cfg = teng.EngineConfig(solver="pgs", warm_start=True, jacobi_iters=5)
    outs = {}
    for dev in ("cuda", "cpu"):
        s, ctl, prm, grid = batch_case(device=dev)
        before = k1.contact_lcp.launches
        outs[dev] = teng.step_batch(model_consts(dev), cfg, grid, s, ctl, prm)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert k1.contact_lcp.launches == before + cfg.decimation
    g, c = outs["cuda"][0], outs["cpu"][0]
    for k, atol in dict(base_pos=5e-4, base_quat=5e-4, dof_pos=1e-3, u=3e-2).items():
        torch.testing.assert_close(getattr(g, k).cpu(), getattr(c, k), rtol=0, atol=atol)


@pytest.mark.cuda
def test_terrain_window_kernel_matches_reference(card):
    """K2 against its plain version, exactly (chip_smoke.py repeats this at
    N = 6144 on the 64-course world): with weights and a ceiling, without
    weights, and on a floor-only grid."""
    grid, c, w, _, _ = layered_case(device="cuda")
    floor_only = grid._replace(layer_id=None, lever=None, ceiling=None, ceiling_layer=None)
    for g, wt in ((grid, w), (grid, None), (floor_only, None)):
        before = k2.terrain_window.launches
        got = k2.terrain_window(g, c, 32, wt)
        torch.cuda.synchronize()
        assert k2.terrain_window.launches == before + 1
        ref = k2.terrain_window_reference(g, c, 32, wt)
        for f in ("values", "x0", "y0") + (("ceil",) if g.ceiling is not None else ()):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_scandots_kernel_matches_reference(card):
    """K3 against its plain version, exactly (bf16 fold, min3, floor node)."""
    grid, c, w, px, py = layered_case(device="cuda")
    for wt in (w, None):
        before = k3.scandots.launches
        got = k3.scandots(grid, c, 34, wt, px, py)
        torch.cuda.synchronize()
        assert k3.scandots.launches == before + 1
        assert torch.equal(got, k3.scandots_reference(grid, c, 34, wt, px, py))


def _grid_variants(grid, w):
    """(grid, weights) cases: every surface with weights, without weights,
    floor only, and weights on a grid with no ceiling."""
    return ((grid, w), (grid, None),
            (grid._replace(layer_id=None, lever=None, ceiling=None, ceiling_layer=None), None),
            (grid._replace(ceiling=None, ceiling_layer=None), w))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 130])
@pytest.mark.parametrize("p", [5, 24, 32, 34])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_terrain_window_kernel_edge_shapes(card, n, p, W):
    """K2 against its plain version, exactly, where the persistent grid is
    larger than N (1, 7) or does not divide it (1000), at odd and even P (4
    floats or a float4 a thread), on both designs (W = 128: staged, TMA and
    cp.async; W = 130: one block per env, plain loads), with windows clamped
    at every edge; two calls give the same bits."""
    grid, c, w, _, _ = window_case(n, W, seed=n + p + W, device="cuda")
    for g, wt in _grid_variants(grid, w):
        cfg = k2.device_launch_config(n, p, g, wt, c.device)
        assert cfg["routes"]["height"] == ("tma" if W % 4 == 0 else "plain")
        got = k2.terrain_window(g, c, p, wt)
        again = k2.terrain_window(g, c, p, wt)
        ref = k2.terrain_window_reference(g, c, p, wt)
        torch.cuda.synchronize()
        for f in ("values", "x0", "y0") + (("ceil",) if g.ceiling is not None else ()):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
            assert torch.equal(getattr(got, f), getattr(again, f)), f
    if n >= 8:
        assert {0, 96 - p}.issubset(set(ref.x0.tolist()))
        assert {0, W - p}.issubset(set(ref.y0.tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [128, 130])
@pytest.mark.parametrize("p", [5, 24, 32, 34])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_scandots_kernel_edge_shapes(card, n, p, W):
    """K3 against its plain version, exactly, at the same shapes and grids
    as K2's edge test, scans clamped at every edge, N not a multiple of the
    8 envs a block; two calls give the same bits."""
    grid, c, w, px, py = window_case(n, W, seed=n + p + W, device="cuda")
    for g, wt in _grid_variants(grid, w):
        assert k3.launch_config(n, px.shape[1], p)["grid"] == -(-n // k3.ENVS_PER_BLOCK)
        got = k3.scandots(g, c, p, wt, px, py)
        again = k3.scandots(g, c, p, wt, px, py)
        ref = k3.scandots_reference(g, c, p, wt, px, py)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 300])
def test_scandots_kernel_point_groups(card, k):
    """K3 against its plain version, exactly, with one point, a warp's
    worth and more than a warp's group of 160 (a second block along y)."""
    grid, c, w, px, py = window_case(7, 128, seed=k, device="cuda", k=k)
    assert torch.equal(k3.scandots(grid, c, 34, w, px, py),
                       k3.scandots_reference(grid, c, 34, w, px, py))


@pytest.mark.cuda
def test_ppo_update_on_card_matches_cpu(card):
    """One PPO update (2 epochs x 2 minibatches) of an 8-env trainer on the
    card against the CPU, from the same weights, transitions and
    permutation: losses and every parameter within 1e-4 relative (norms of
    the difference over each network)."""
    from agility_tpu_torch.envs.config import smoke_cfg
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn import ssinfogail as sg
    from agility_tpu_torch.learn.networks import gaussian_log_prob

    acfg = sg.AlgoCfg(num_steps_per_env=8, num_preload_transitions=256,
                      disc_replay_buffer_size=512, num_learning_epochs=2, num_mini_batches=2)
    algs = [sg.SSInfoGAIL(Go2LocomotionEnv(smoke_cfg(8), d), acfg, seed=0) for d in ("cpu", "cuda")]
    (ca, cts), (ga, gts) = ((a, a.init_train_state()) for a in algs)
    for k in ("ac", "est"):
        getattr(gts, k).load_state_dict(getattr(cts, k).state_dict())
    g = torch.Generator().manual_seed(0)
    obs = 0.5 * torch.randn(8, 8, ca.slices.total, generator=g)
    with torch.no_grad():
        mean = cts.ac.action_mean(obs.reshape(64, -1)).reshape(8, 8, -1)
        std = cts.ac.std.detach().clone().expand_as(mean)
        actions = mean + std * torch.randn(mean.shape, generator=g)
        trs = sg.Transition(obs, obs, actions, 0.1 * torch.randn(8, 8, generator=g),
                            torch.rand(8, 8, generator=g) < 0.1, cts.ac.value(obs),
                            gaussian_log_prob(mean, std, actions), mean, std)
    adv, ret = ca.compute_gae(trs, torch.zeros(8))
    perm = torch.randperm(64, generator=g)
    cm = ca.ppo_update(cts, trs, adv, ret, perm)
    gm = ga.ppo_update(gts, sg.Transition(*(x.cuda() for x in trs)), adv.cuda(), ret.cuda(),
                       perm.cuda())
    for k in cm:
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-4 * max(abs(float(cm[k])), 1e-3), k
    for k in ("ac", "est"):
        a = torch.cat([p.detach().flatten() for p in getattr(gts, k).parameters()]).cpu()
        b = torch.cat([p.detach().flatten() for p in getattr(cts, k).parameters()])
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-4, k


@pytest.mark.cuda
def test_vision_iteration_on_card(card):
    """One depth-student iteration (T = 8: camera chunks of 5 and 3, the
    distillation update, two BYOL minibatches) of 8 envs on 2 courses on
    the card: each control step launches K1 four times and K2 and K3 once,
    every metric and parameter is finite, and the update moved the encoder
    (chip_smoke.py's `vision parity` holds it against the CPU at 64 envs)."""
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg
    from agility_tpu_torch.io.checkpoint import load_bbc_frozen
    from agility_tpu_torch.learn.ppo_tsc import TscPPO
    from agility_tpu_torch.learn.vision_tsc import TscVision, VisionCfg

    alg = TscPPO(Go2AgilityEnv(tsc_smoke_cfg(8, 2), "cuda", seed=0), load_bbc_frozen(None), seed=0)
    vision = TscVision(alg.env, alg._ac0, alg._est0, alg.bbc_ac,
                       VisionCfg(num_steps_per_env=8, byol_minibatches=2), seed=0)
    ts = vision.init_train_state()
    enc0 = ts.enc.backbone.fc0.weight.detach().clone()
    es = alg.env.init_state()
    counts = lambda: (k1.contact_lcp.launches, k2.terrain_window.launches, k3.scandots.launches)
    before = counts()
    ts, es, m = vision.train_iteration(ts, es)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, counts())) == (32, 8, 8)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert all(bool(torch.isfinite(p).all()) for mod in (ts.enc, ts.actor, ts.byol)
               for p in mod.parameters())
    assert not torch.equal(ts.enc.backbone.fc0.weight, enc0)


@pytest.mark.cuda
def test_mocap_load_dir_on_card_matches_cpu(card, tmp_path):
    """envs/mocap.load_dir onto the card gives the tables it gives on the
    CPU, bit for bit, from clip files in the reference's layout
    (torch_cases.write_clip_dir: two clips a mode at two frame durations,
    two unlabelled files)."""
    from agility_tpu_torch.envs import mocap
    from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
    from torch_cases import write_clip_dir

    write_clip_dir(str(tmp_path))
    dirs = (str(tmp_path / "mocap_all_lb"), str(tmp_path / "mocap_all_ulb"))
    gpu = mocap.load_dir(*dirs, MOCAP_CATEGORIES, "cuda")
    cpu = mocap.load_dir(*dirs, MOCAP_CATEGORIES, "cpu")
    assert gpu.frames.is_cuda and gpu.ulb_dur == cpu.ulb_dur
    for k, v in cpu._asdict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(gpu, k).cpu(), v), k


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_one(card):
    """dist/mesh.py on the card: two gloo ranks on cuda:0 (NCCL refuses two
    ranks on one device) each run one BBC and one TSC teacher iteration of
    16 envs on their 8 (tests/torch_dist_cases.py), launching the kernels;
    the ranks' parameters are bit-identical and within tests/test_dist.py's
    1e-3 / 1e-4 of the same iterations in this process without a group,
    rollout/r_total within 1e-4."""
    import numpy as np

    import torch_dist_cases as cases
    from agility_tpu_torch.dist import mesh

    for case, launched in ((cases.bbc_iteration, ("contact_lcp", "terrain_window")),
                           (cases.tsc_iteration, ("contact_lcp", "terrain_window", "scandots"))):
        one = case("cuda")
        two = mesh.launch(case, 2, args=("cuda",), backend="gloo", device="cuda",
                          timeout_s=300.0)
        assert torch.equal(two[0]["params"], two[1]["params"])
        np.testing.assert_allclose(two[0]["params"].numpy(), one["params"].numpy(), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(two[0]["metrics"]["rollout/r_total"],
                                   one["metrics"]["rollout/r_total"], rtol=1e-4)
        for part in two:
            assert all(part["launches"][k] > 0 for k in launched), part["launches"]


@pytest.mark.cuda
def test_bench_lines_on_card(card):
    """agility_tpu_torch/bench.py's two lines at a small width on the card
    (64 envs; the TSC on 8 courses), one timed iteration: the root bench's
    keys, finite values > 0, the card named by nvidia-smi."""
    import dataclasses
    import math

    from agility_tpu_torch import bench

    cfg = bench.tsc_config(64)
    cfg = dataclasses.replace(cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=8))
    for (out, dt), metric in ((bench.bench_bbc("cuda", 64, iters=1, fast=True),
                               "env_steps_per_sec"),
                              (bench.bench_tsc("cuda", iters=1, cfg=cfg),
                               "tsc_env_steps_per_sec")):
        assert out["metric"] == metric and out["unit"] == "env-steps/s"
        assert out["value"] == round(24 * 64 / dt, 1) > 0 and math.isfinite(out["value"])
        assert "vs_baseline" not in out
        assert len(out["iter_ms"]) == 1 and out["iter_ms"][0] > 0
        assert out["device"].startswith(torch.cuda.get_device_name(0))


@pytest.mark.cuda
def test_ablation_variant_on_card(card):
    """One ablation variant on the card ("no _measure_heights", the TSC at
    64 envs on 8 courses, T = 2): the scandot kernel is not launched, the
    other two are, and the step's device ops are counted."""
    import dataclasses

    from agility_tpu_torch import bench
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.tools import bench_env_ablate, bench_env_ablate_tsc

    cfg = bench.tsc_config(64)
    env = Go2AgilityEnv(dataclasses.replace(
        cfg, obstacle=dataclasses.replace(cfg.obstacle, courses=8)), "cuda")
    label, patches = bench_env_ablate_tsc.variants(env)[2]
    assert label == "no _measure_heights"
    begin = bench_env_ablate.start(env)
    row = bench_env_ablate.bench(env, label, begin, 2, 1, **patches)
    assert row["finite"] and row["launches"] == dict(contact_lcp=4, terrain_window=1, scandots=0,
                                                    per_env_windows=0, band_windows=0,
                                                    free_dynamics=4)
    assert bench_env_ablate.device_ops(env, begin, **patches) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000])
@pytest.mark.parametrize("shape", [("f32", 5, 32, 32), ("bf16", 3, 56, 8), ("bf16", 3, 36, 16),
                                   ("f32", 2, 5, 4), ("bf16", 1, 3, 2)])
def test_window_dma_kernels_match_reference(card, n, shape):
    """D and E against their plain versions, bit for bit, on a 1 x 2 ... K
    surface world of 200 x 203 (an odd width: D takes its "rows" route, most
    of its rows unaligned): D with origins anywhere up to 10 cells off the
    grid and with Pc != P, E at its clipped origins (including off the
    stack); each wrapper counts one launch a call, and two calls give the
    same bits."""
    from agility_tpu_torch.kernels import window_dma as wd

    dt, K, P, stride = shape
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    gen = torch.Generator().manual_seed(n * 100 + P)
    g = torch.randn((K, 200, 203), generator=gen).to("cuda", dtype)
    x0 = torch.randint(-10, 200, (n,), generator=gen, dtype=torch.int32).cuda()
    y0 = torch.randint(-10, 203, (n,), generator=gen, dtype=torch.int32).cuda()
    for Pc in (P, P + 3):
        before = wd.per_env_windows.launches
        rows = wd.per_env_windows.route_launches["rows"]
        out = wd.per_env_windows(g, x0, y0, P, Pc)
        again = wd.per_env_windows(g, x0, y0, P, Pc)
        torch.cuda.synchronize()
        assert wd.per_env_windows.launches == before + 2
        assert wd.per_env_windows.route_launches["rows"] == rows + 2
        ref = wd.per_env_windows_reference(g, x0, y0, P, Pc)
        bits = torch.int16 if dt == "bf16" else torch.int32
        assert torch.equal(out.view(bits), ref.view(bits))
        assert torch.equal(out.view(bits), again.view(bits))
    band = 64 if P > 8 else 8
    al = wd.sublane(dtype)
    G2 = wd.band_stack(g, P, band, stride, al)
    before = wd.band_windows.launches
    out = wd.band_windows(G2, x0, y0, P, band, stride, al)
    again = wd.band_windows(G2, x0, y0, P, band, stride, al)
    torch.cuda.synchronize()
    assert wd.band_windows.launches == before + 2
    bits = torch.int16 if dt == "bf16" else torch.int32
    ref = wd.band_windows_reference(G2, x0, y0, P, band, stride, al)
    assert torch.equal(out.view(bits), ref.view(bits))
    assert torch.equal(out.view(bits), again.view(bits))


@pytest.mark.cuda
def test_window_dma_unaligned_and_in_range(card):
    """D on a 400-wide float32 grid ("tma") and on a view of it whose base
    is 4 bytes past 16-byte alignment ("rows": vector rows where the origin
    lands on a 16-byte boundary, scalar rows beside them), and E's element
    route on a stack whose base is not 16-byte aligned: equal to the plain
    versions."""
    from agility_tpu_torch.kernels import window_dma as wd

    g = torch.randn((5, 300, 400), device="cuda")
    x0 = torch.arange(64, dtype=torch.int32, device="cuda") * 3
    y0 = torch.arange(64, dtype=torch.int32, device="cuda") * 5
    routes = dict(wd.per_env_windows.route_launches)
    assert torch.equal(wd.per_env_windows(g, x0, y0, 32), wd.per_env_windows_reference(
        g, x0, y0, 32))
    flat = torch.empty(g.numel() + 1, device="cuda")
    gu = flat[1:].view(g.shape)
    gu.copy_(g)
    assert torch.equal(wd.per_env_windows(gu, x0, y0, 32), wd.per_env_windows_reference(
        g, x0, y0, 32))
    assert wd.per_env_windows.route_launches == dict(tma=routes["tma"] + 1,
                                                     rows=routes["rows"] + 1)
    G2 = wd.band_stack(g, 32, 64, 32, 8)
    flat = torch.empty(G2.numel() + 1, device="cuda")
    G2u = flat[1:].view(G2.shape)
    G2u.copy_(G2)
    assert G2u.data_ptr() % 16 == 4
    out = wd.band_windows(G2u, x0, y0, 32, 64, 32, 8)
    assert torch.equal(out, wd.band_windows_reference(G2, x0, y0, 32, 64, 32, 8))


def _off_grid_origins(n, H, W, P, Pc, gen, off=10):
    """n origins up to `off` cells beyond every edge (negative ones
    included), the last two windows wholly outside the grid (one above and
    left of it, one below and right)."""
    x0 = torch.randint(-off, H + off - P + 1, (n,), generator=gen, dtype=torch.int32)
    y0 = torch.randint(-off, W + off - Pc + 1, (n,), generator=gen, dtype=torch.int32)
    if n >= 2:
        x0[-2], y0[-2] = -P, -Pc - 3
        x0[-1], y0[-1] = H + 1, W
    else:
        x0[0], y0[0] = -P - 1, W + 2
    return x0.cuda(), y0.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000, 6144])
@pytest.mark.parametrize("shape", [("f32", 5, 32, 32), ("f32", 5, 32, 35), ("bf16", 3, 56, 56),
                                   ("bf16", 3, 56, 36), ("bf16", 3, 36, 36), ("f32", 2, 5, 3),
                                   ("bf16", 1, 3, 7)])
def test_window_dma_tma_route_matches_reference(card, n, shape):
    """D's "tma" route on a 200 x 208 grid (16-byte row pitch in float32 and
    bfloat16), bit for bit against the plain version: origins up to 10
    cells off every edge and windows wholly outside (the tensor map's zero
    fill), Pc = P and Pc not a multiple of the 16-byte vector (35 float32,
    36 bfloat16; 3 and 7, narrower than a vector), N not a multiple of the
    grid; each call one launch on the "tma" route, two calls the same
    bits.  The input's NaN payloads and negative zeros come through as
    they are."""
    from agility_tpu_torch.kernels import window_dma as wd

    dt, K, P, Pc = shape
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    bits = torch.int16 if dt == "bf16" else torch.int32
    H, W = 200, 208
    gen = torch.Generator().manual_seed(n * 1000 + P * 10 + Pc)
    g = torch.randn((K, H, W), generator=gen).to(dtype)
    raw = g.view(bits)
    raw[0, 0, :4] = torch.tensor([0x7FC00123, 0x7F800001, -0x80000000, 0x7FC00000],
                                 dtype=torch.int64).to(bits) if dt == "f32" else \
        torch.tensor([0x7FC1, 0x7F81, -0x8000, 0x7FC0], dtype=bits)
    g = g.cuda()
    x0, y0 = _off_grid_origins(n, H, W, P, Pc, gen)
    x0[0], y0[0] = 0, 0
    cfg = wd.device_per_env_config(n, K, H, W, P, Pc, dtype, g.device, g.data_ptr())
    assert cfg["route"] == "tma" and 1 <= cfg["grid"] <= n
    before = dict(wd.per_env_windows.route_launches)
    out = wd.per_env_windows(g, x0, y0, P, Pc)
    again = wd.per_env_windows(g, x0, y0, P, Pc)
    torch.cuda.synchronize()
    assert wd.per_env_windows.route_launches == dict(tma=before["tma"] + 2, rows=before["rows"])
    ref = wd.per_env_windows_reference(g, x0, y0, P, Pc)
    assert torch.equal(out.view(bits), ref.view(bits))
    assert torch.equal(out.view(bits), again.view(bits))
    c = min(4, Pc)
    assert torch.equal(out[0, 0, 0, :c].view(bits).cpu(), raw[0, 0, :c])
    if n >= 2:
        assert not out[-2:].view(bits).any()
