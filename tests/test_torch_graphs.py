"""The SoA substep's stages and their graphs (soa.stage_a, soa.stage_b,
physics/graphs.py) on the CPU: GraphCache calls the stage functions
directly there and counts nothing, so the substep is the chain of the stage
functions written out (pre_contact, contact_problem, K1, the apply and
integrate) exactly; what the key derived from the inputs tells apart; the
static copies keep the inputs' tree; the control step's results are its
substeps'.  The replay itself runs only on a card (tests/test_torch_cuda.py)."""
import dataclasses

import pytest
import torch

from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.physics import graphs
from agility_tpu_torch.physics import soa as tsoa
from torch_cases import CFG, TMC, batch_case, layered_case


def _leaves(x):
    """Every tensor of a nested dict / list / tuple, in order (a dict's in
    insertion order)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
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
    """Stage A written out: pre_contact, contact_problem from zero impulses."""
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    want["problem"] = tsoa.contact_problem(
        want["phi"], want["n"], want["r"], want["lever"], want["f"], want["u_free"],
        prm["friction"], CFG.dt, **tsoa.contact_kwargs(CFG))
    want["state"] = sd
    return want


@pytest.mark.parametrize("ceiling", [False, True])
def test_free_dynamics_on_cpu_is_pre_contact(ceiling):
    """Stage A through FREE_DYNAMICS on CPU tensors: pre_contact's results
    and K1's inputs exactly, no capture and no replay."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    assert (ceil_sampler is not None) == ceiling
    inputs, samplers = (sd, target, kp, kd, prm), (sampler, ceil_sampler)
    before = _counts()
    got = tsoa.FREE_DYNAMICS(graphs.key((inputs, samplers)), TMC,
                             lambda a, s: tsoa.stage_a(TMC, CFG, *a, *s), inputs, samplers)
    want = _pre_solve(sd, target, kp, kd, prm, sampler, ceil_sampler)
    assert _counts() == before
    assert len(got["problem"]) == 8
    assert len(_leaves(got)) == len(_leaves(want)) > 0
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ceiling", [False, True])
def test_substep_on_cpu_is_the_eager_chain(ceiling, warm):
    """On CPU tensors the substep is the chain written out (pre_contact, K1
    through jacobi_solve, integrate) exactly, and neither cache captures or
    replays."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    lam0 = _lam0(sd, ceiling) if warm else None
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
    """jacobi_solve is contact_problem, K1 and apply_impulses: stage B runs
    apply_impulses on K1's output."""
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


class _Keys(graphs.GraphCache):
    """A GraphCache that records the key of every call; with `stop` it
    raises _Stop in place of running the stage."""

    def __init__(self, stop=False):
        super().__init__()
        self.keys, self.stop = [], stop

    def __call__(self, key, *args, **kwargs):
        self.keys.append(key)
        if self.stop:
            raise _Stop
        return super().__call__(key, *args, **kwargs)


class _Stop(Exception):
    pass


def _key(monkeypatch, change=None):
    """The key the substep derives for _inputs(), or for one change to
    them."""
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
    elif change == "dtype":
        prm = dict(prm, friction=prm["friction"].double())
    elif change in ("baumgarte", "restitution"):
        cfg = dataclasses.replace(CFG, **{change: getattr(CFG, change) + 0.1})
    elif change == "enforce_joint_limits":
        cfg = dataclasses.replace(CFG, enforce_joint_limits=not CFG.enforce_joint_limits)
    elif change == "origin":
        sampler = sampler._replace(origin=(sampler.origin[0] + 0.05, sampler.origin[1]))
    elif change == "hscale":
        sampler = sampler._replace(hscale=2 * sampler.hscale)
    keys = _Keys(stop=True)
    with monkeypatch.context() as m:
        m.setattr(tsoa, "FREE_DYNAMICS", keys)
        if change == "allow_tf32":
            m.setattr(torch.backends.cuda.matmul, "allow_tf32",
                      not torch.backends.cuda.matmul.allow_tf32)
        with pytest.raises(_Stop):
            tsoa.substep(mc, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler)
    return keys.keys[0]


@pytest.mark.parametrize("change", ["ceiling", "com_shift", "added_mass", "fewer_envs",
                                    "model", "dt", "window", "friction_per_contact",
                                    "baumgarte", "restitution", "enforce_joint_limits",
                                    "allow_tf32", "origin", "hscale", "dtype"])
def test_free_dynamics_key_tells_structures_apart(monkeypatch, change):
    """A graph is captured for each structure: with and without the ceiling
    rows, without com_shift or added_mass, at another N, for another model,
    with another window size P, with friction per contact or in another
    dtype, with another dt, other contact settings or joint-limit setting,
    another matmul precision, or another grid origin or spacing under the
    samplers.  A warm start is no structure: its lam0 goes to K1 outside
    the graphs.  The key does not change with new tensors of the same
    structure (_inputs() builds them anew: the next control step's state,
    params and window)."""
    assert _key(monkeypatch) == _key(monkeypatch)
    assert _key(monkeypatch, change) != _key(monkeypatch)


def test_both_stages_share_one_key(monkeypatch):
    """The substep hands both caches one key, so stage B's entry always
    reads the same entry of stage A (graphs.py's contract for a borrowed
    graph), warm or cold."""
    sd, args = _inputs(ceiling=True)
    first, second = _Keys(), _Keys()
    monkeypatch.setattr(tsoa, "FREE_DYNAMICS", first)
    monkeypatch.setattr(tsoa, "CONTACT_APPLY", second)
    tsoa.substep(TMC, CFG, sd, *args)
    tsoa.substep(TMC, CFG, sd, *args, lam0=_lam0(sd, True))
    assert first.keys == second.keys
    assert first.keys[0] == first.keys[1]
    assert (first.captures, first.replays, second.captures, second.replays) == (0, 0, 0, 0)


def test_graph_cache_on_cpu_calls_fn():
    """GraphCache on CPU tensors calls fn(args, held) with the trees it was
    handed, returns what fn returns, and neither captures, replays nor
    keeps an entry."""
    cache = graphs.GraphCache()
    args = (tsoa.SoAState(*(torch.full((k, 2), float(k)) for k in (3, 4, 12, 18))),
            dict(a=torch.ones(2), b=(torch.zeros(1), 2.0)))
    held = [torch.arange(3.0), None]
    seen = []

    def fn(a, h):
        seen.append((a, h))
        return a[0].u.sum() + h[0].sum()

    for _ in range(2):
        assert float(cache(graphs.key((args, held)), TMC, fn, args, held)) == 18 * 2 * 18 + 3
    assert all(a is args and h is held for a, h in seen)
    assert (cache.captures, cache.replays, cache._graphs) == (0, 0, {})


def test_static_inputs_keep_the_tree():
    """The graph's static inputs are the substep's inputs' tree, NamedTuples,
    dicts and None kept, with a new tensor of the same shape, strides and
    dtype for each tensor leaf and every other leaf as it was, in the
    order GraphCache copies them."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling=True)
    tree = ((sd, target[:, ::2], kp, kd, prm), (sampler, None))
    static, tensors = graphs._static(tree)
    assert type(static[0][0]) is tsoa.SoAState and type(static[1][0]) is tsoa.PatchSampler
    assert static[1][1] is None and list(static[0][4]) == list(prm)
    assert static[1][0][3:] == sampler[3:]
    assert all(a is b for a, b in zip(tensors, _leaves(static), strict=True))
    src = _leaves(tree)
    assert len(tensors) == len(src) == 4 + 3 + 7 + 3
    for a, b in zip(tensors, src):
        assert a is not b
        assert (a.shape, a.stride(), a.dtype) == (b.shape, b.stride(), b.dtype)
    assert graphs.key(static) == graphs.key(tree)


@pytest.mark.parametrize("ceiling", [False, True])
def test_control_step_is_its_substeps(ceiling):
    """control_step_batched equals its substeps run one by one on the
    inputs batch_inputs builds, warm-started as the step does."""
    s, ctl, prm, grid = batch_case()
    if ceiling:
        grid = layered_case()[0]
    cfg = teng.EngineConfig(warm_start=True, jacobi_iters=5)
    got = tsoa.control_step_batched(TMC, cfg, grid, s, ctl, prm)
    sd, args, _ = tsoa.batch_inputs(cfg, grid, s, ctl, prm)
    lam = None
    for _ in range(cfg.decimation):
        sd, taus, _, lam = tsoa.substep(TMC, cfg, sd, *args, lam0=lam)
    want_state = teng.EnvState(sd.bp.T, sd.bq.T, sd.q.T, sd.u.T)
    for a, b in zip(_leaves((want_state, (taus[0].T, taus[1].T))), _leaves(got[:2]),
                    strict=True):
        assert torch.equal(a, b)
