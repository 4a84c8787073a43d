"""The SoA substep's graph path (soa.free_dynamics and soa.contact_apply,
physics/graphs.py) on the CPU: where it does not engage, the results are the
eager chain's exactly (pre_contact, contact_problem, K1, the apply and
integrate) and neither cache captures; what the two keys tell apart; the
control step's results with the samplers it builds.  The replay itself runs
only on a card (tests/test_torch_cuda.py)."""
import dataclasses

import pytest
import torch

from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import soa as tsoa
from torch_cases import CFG, TMC, batch_case, layered_case


def _leaves(x):
    """Every tensor of a nested dict / list / tuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _inputs(ceiling=False, n=None, cfg=CFG):
    s, ctl, prm, grid = batch_case()
    if ceiling:
        grid = layered_case()[0]
    if n is not None:
        cut = lambda nt: type(nt)(*(None if v is None else v[:n] for v in nt))
        s, ctl, prm = cut(s), cut(ctl), cut(prm)
    sd, args, _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
    return sd, args


def _counts():
    return [(g.captures, g.replays) for g in (tsoa.FREE_DYNAMICS, tsoa.CONTACT_APPLY)]


def _lam0(sd, ceiling):
    """A warm start's impulses (3, S', N), as the previous substep's K1 gives."""
    rows = 24 + (tsoa.consts_of(TMC).n_ceil if ceiling else 0)
    return torch.linspace(0.0, 0.05, 3 * rows * sd.bp.shape[1]).reshape(3, rows, -1)


def _pre_solve(sd, target, kp, kd, prm, sampler, ceil_sampler):
    """The eager chain up to K1, written out: pre_contact, contact_problem
    from zero impulses."""
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    want["problem"] = tsoa.contact_problem(
        want["phi"], want["n"], want["r"], want["lever"], want["f"], want["u_free"],
        prm["friction"], CFG.dt, **tsoa.contact_kwargs(CFG))
    want["state"] = sd
    return want


@pytest.mark.parametrize("ceiling", [False, True])
def test_free_dynamics_on_cpu_is_pre_contact(ceiling):
    """CPU tensors take the eager path: pre_contact's results and K1's
    inputs exactly, no capture and no replay."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    assert (ceil_sampler is not None) == ceiling
    assert not tsoa.graphed(sd, target, kp, kd, prm, sampler, ceil_sampler)
    before = _counts()
    got = tsoa.free_dynamics(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    want = _pre_solve(sd, target, kp, kd, prm, sampler, ceil_sampler)
    assert _counts() == before
    assert len(got["problem"]) == 8
    assert len(_leaves(got)) == len(_leaves(want)) > 0
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


def test_closure_sampler_takes_the_eager_path():
    """A sampler that is a plain closure (as tools/bench_substep.py passes)
    runs pre_contact and the contact problem eagerly, with the closure's
    results."""
    sd, (target, kp, kd, prm, sampler, _) = _inputs()
    closure = lambda x, y: sampler(x, y)
    before = _counts()
    got = tsoa.free_dynamics(TMC, CFG, sd, target, kp, kd, prm, closure)
    want = _pre_solve(sd, target, kp, kd, prm, sampler, None)
    assert _counts() == before
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ceiling", [False, True])
@pytest.mark.parametrize("closure", [False, True])
def test_substep_on_cpu_is_the_eager_chain(ceiling, warm, closure):
    """On CPU tensors, and with closure samplers, the substep is the eager
    chain written out (pre_contact, K1 through jacobi_solve, integrate)
    exactly, and neither cache captures or replays."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    lam0 = _lam0(sd, ceiling) if warm else None
    if closure:
        sampler = (lambda smp: lambda x, y: smp(x, y))(sampler)
        ceil_sampler = None if ceil_sampler is None else (
            lambda smp: lambda x, y: smp(x, y))(ceil_sampler)
    before = _counts()
    got = tsoa.substep(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler, lam0=lam0)
    p = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    u_new, force, lam = tsoa.jacobi_solve(
        p["phi"], p["n"], p["r"], p["lever"], p["f"], p["u_free"], prm["friction"], CFG.dt,
        iters=CFG.jacobi_iters, relax=CFG.jacobi_relax, lam0=lam0, **tsoa.contact_kwargs(CFG))
    want = (tsoa.integrate(tsoa.consts_of(TMC), CFG, sd, p["f"], u_new),
            (p["tau_j"], p["tau_org"]), force, lam)
    assert _counts() == before
    assert len(_leaves(got)) == len(_leaves(want)) == 4 + 2 + 2
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)
    assert float(force.abs().max()) > 0.0               # contacts carry impulse


@pytest.mark.parametrize("ceiling", [False, True])
def test_apply_impulses_is_jacobi_solves_tail(ceiling):
    """jacobi_solve is contact_problem, K1 and apply_impulses: the graph
    after K1 runs apply_impulses on K1's output."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    p = _pre_solve(sd, target, kp, kd, prm, sampler, ceil_sampler)
    lam = tsoa.contact_lcp(*p["problem"], iters=CFG.jacobi_iters, relax=CFG.jacobi_relax)
    got = tsoa.apply_impulses(lam, p["r"], p["lever"], p["f"], p["u_free"], CFG.dt)
    want = tsoa.jacobi_solve(
        p["phi"], p["n"], p["r"], p["lever"], p["f"], p["u_free"], prm["friction"], CFG.dt,
        iters=CFG.jacobi_iters, relax=CFG.jacobi_relax, **tsoa.contact_kwargs(CFG))
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert torch.equal(a, b)


def test_patch_sampler_is_the_patch_samplers():
    """PatchSampler(x, y) is patch_sample_hn, and with `ceiling`
    patch_sample_ceiling, on its tensors."""
    sd, (*_, sampler, ceil_sampler) = _inputs(ceiling=True)
    x, y = sd.bp[0][None].repeat(3, 1), sd.bp[1][None].repeat(3, 1)
    for smp, fn in ((sampler, tsoa.patch_sample_hn), (ceil_sampler, tsoa.patch_sample_ceiling)):
        want = fn(smp.values_T, smp.x0, smp.y0, smp.origin, smp.hscale, x, y)
        for a, b in zip(_leaves(smp(x, y)), _leaves(want)):
            assert torch.equal(a, b)


def _key(change=None):
    """(free_dynamics_key, contact_apply_key) of _inputs(), or of one change
    to them."""
    window = dataclasses.replace(CFG, patch_size=CFG.patch_size + 8)
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(
        ceiling=change == "ceiling", n=4 if change == "fewer_envs" else None,
        cfg=window if change == "window" else CFG)
    mc, cfg = TMC, CFG
    if change in ("com_shift", "added_mass"):
        prm = {k: v for k, v in prm.items() if k != change}
    elif change == "model":
        mc = dataclasses.replace(TMC)
    elif change == "dt":
        cfg = dataclasses.replace(CFG, dt=CFG.dt / 2)
    elif change == "friction_per_contact":
        prm = dict(prm, friction=prm["friction"][None].expand(24, -1))
    elif change in ("baumgarte", "restitution"):
        cfg = dataclasses.replace(CFG, **{change: getattr(CFG, change) + 0.1})
    elif change == "enforce_joint_limits":
        cfg = dataclasses.replace(CFG, enforce_joint_limits=not CFG.enforce_joint_limits)
    free = tsoa.free_dynamics_key(mc, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler)
    return free, tsoa.contact_apply_key(free, cfg)


@pytest.mark.parametrize("change", ["ceiling", "com_shift", "added_mass", "fewer_envs",
                                    "model", "dt", "window", "friction_per_contact",
                                    "baumgarte", "restitution"])
def test_free_dynamics_key_tells_structures_apart(change):
    """A graph is captured for each structure: with and without the ceiling
    rows, without com_shift or added_mass, at another N, for another model
    or dt, with another window size P, with friction per contact, with
    other contact settings; the graph after K1 follows it.  A warm start
    is no structure: its lam0 goes to K1 outside the graphs.  The keys do not change with
    new tensors of the same structure (_inputs() builds them anew: the next
    control step's state, params and window)."""
    assert _key() == _key()
    assert _key(change)[0] != _key()[0]
    assert _key(change)[1] != _key()[1]


def test_contact_apply_key_tells_joint_limits_apart():
    """The graph after K1 is captured anew where the integration enforces
    the joint limits or not; the first graph does not read the setting."""
    assert _key("enforce_joint_limits")[0] == _key()[0]
    assert _key("enforce_joint_limits")[1] != _key()[1]


@pytest.mark.parametrize("ceiling", [False, True])
def test_control_step_as_substeps_with_closures(ceiling):
    """control_step_batched equals its substeps run with the samplers as
    plain closures (the eager path whatever the device)."""
    s, ctl, prm, grid = batch_case()
    if ceiling:
        grid = layered_case()[0]
    cfg = teng.EngineConfig(warm_start=True, jacobi_iters=5)
    got = tsoa.control_step_batched(TMC, cfg, grid, s, ctl, prm)
    sd, (target, kp, kd, p, sampler, ceil_sampler), _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
    closure = lambda smp: None if smp is None else (lambda x, y: smp(x, y))
    lam = None
    for _ in range(cfg.decimation):
        sd, taus, _, lam = tsoa.substep(TMC, cfg, sd, target, kp, kd, p, closure(sampler),
                                        closure(ceil_sampler), lam0=lam)
    want_state = teng.EnvState(sd.bp.T, sd.bq.T, sd.q.T, sd.u.T)
    for a, b in zip(_leaves((want_state, (taus[0].T, taus[1].T))), _leaves(got[:2])):
        assert torch.equal(a, b)
