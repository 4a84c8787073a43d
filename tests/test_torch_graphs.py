"""The SoA free dynamics' graph path (soa.free_dynamics, physics/graphs.py) on
the CPU: where it does not engage, its results are pre_contact's exactly and
nothing is captured; what its key tells apart; the control step's results
with the samplers it now builds.  The replay itself runs only on a card
(tests/test_torch_cuda.py)."""
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


def _inputs(ceiling=False, n=None):
    s, ctl, prm, grid = batch_case()
    if ceiling:
        grid = layered_case()[0]
    if n is not None:
        cut = lambda nt: type(nt)(*(None if v is None else v[:n] for v in nt))
        s, ctl, prm = cut(s), cut(ctl), cut(prm)
    sd, args, _ = tsoa.batch_inputs(CFG, grid, s, ctl, prm)
    return sd, args


def _counts():
    return tsoa.FREE_DYNAMICS.captures, tsoa.FREE_DYNAMICS.replays


@pytest.mark.parametrize("ceiling", [False, True])
def test_free_dynamics_on_cpu_is_pre_contact(ceiling):
    """CPU tensors take the eager path: pre_contact's results exactly, no
    capture and no replay."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(ceiling)
    assert (ceil_sampler is not None) == ceiling
    before = _counts()
    got = tsoa.free_dynamics(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler, ceil_sampler)
    assert _counts() == before
    assert len(_leaves(got)) == len(_leaves(want)) > 0
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


def test_closure_sampler_takes_the_eager_path():
    """A sampler that is a plain closure (as tools/bench_substep.py passes)
    runs pre_contact eagerly, with the closure's results."""
    sd, (target, kp, kd, prm, sampler, _) = _inputs()
    closure = lambda x, y: sampler(x, y)
    before = _counts()
    got = tsoa.free_dynamics(TMC, CFG, sd, target, kp, kd, prm, closure)
    want = tsoa.pre_contact(TMC, CFG, sd, target, kp, kd, prm, sampler)
    assert _counts() == before
    for a, b in zip(_leaves(got), _leaves(want)):
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
    """free_dynamics_key of _inputs(), or of one change to them."""
    sd, (target, kp, kd, prm, sampler, ceil_sampler) = _inputs(
        ceiling=change == "ceiling", n=4 if change == "fewer_envs" else None)
    mc, cfg = TMC, CFG
    if change in ("com_shift", "added_mass"):
        prm = {k: v for k, v in prm.items() if k != change}
    elif change == "model":
        mc = dataclasses.replace(TMC)
    elif change == "dt":
        cfg = dataclasses.replace(CFG, dt=CFG.dt / 2)
    return tsoa.free_dynamics_key(mc, cfg, sd, target, kp, kd, prm, sampler, ceil_sampler)


@pytest.mark.parametrize("change", ["ceiling", "com_shift", "added_mass", "fewer_envs",
                                    "model", "dt"])
def test_free_dynamics_key_tells_structures_apart(change):
    """A graph is captured for each structure: with and without the ceiling
    rows, without com_shift or added_mass, at another N, for another model
    or dt; the key does not change with new tensors of the same structure
    (_inputs() builds them anew: the next control step's state, params and
    window)."""
    assert _key() == _key()
    assert _key(change) != _key()


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
