"""The port's depth student (render/raycast.py, learn/depth.py,
learn/vision_tsc.py) against the benchmark's plain reference of it
(benchmark/reference/plain), on the CPU at 8 envs on 2 courses with seeded
random weights: the rendered and processed refresh images, the encoder
step, one update with BYOL and one training iteration with injected draws.
On the CPU the two run the same plain torch on the same inputs, so every
comparison is exact: a difference is a change of semantics on one side.
Images are compared on the pixels `crossing_mask` keeps, as the benchmark
judges them, and the pixels it leaves out are held few.

Also the student's spans and counters (agility_tpu_torch/trace.py): on,
they nest under the trainer's stages and count N * H * W * 32 march
samples a render; off, nothing is recorded; and the reference imports
neither the JAX package nor the port."""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from agility_tpu_torch import trace  # noqa: E402
from agility_tpu_torch.envs import go2_agility as tenv  # noqa: E402
from agility_tpu_torch.envs.tsc_config import tsc_smoke_cfg  # noqa: E402
from agility_tpu_torch.learn import depth as tdepth  # noqa: E402
from agility_tpu_torch.learn import networks as tnets  # noqa: E402
from agility_tpu_torch.learn import networks_tsc as ttsc  # noqa: E402
from agility_tpu_torch.learn import vision_tsc as tvis  # noqa: E402
from agility_tpu_torch.render import raycast as trc  # noqa: E402
from benchmark.reference.plain.envs import go2_agility as renv  # noqa: E402
from benchmark.reference.plain.envs import tsc_config as rcfg  # noqa: E402
from benchmark.reference.plain.learn import depth as rdepth  # noqa: E402
from benchmark.reference.plain.learn import networks as rnets  # noqa: E402
from benchmark.reference.plain.learn import networks_tsc as rtsc  # noqa: E402
from benchmark.reference.plain.learn import vision_tsc as rvis  # noqa: E402
from benchmark.reference.plain.render import raycast as rrc  # noqa: E402

N, COURSES, SEED = 8, 2, 5
CFG = dataclasses.replace(tvis.VisionCfg(), num_steps_per_env=6)   # two refreshes
LEFT_OUT = 0.05          # the share of pixels the crossing rule may leave out


@pytest.fixture(autouse=True)
def quiet_tracing():
    """Tracing off and no records around each test, on one thread."""
    trace.disable()
    trace.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.disable()
    trace.reset()


def _nets(nets, tsc, slices_args, e):
    """A TSC teacher (actor-critic, estimator) and a frozen BBC actor of one
    package, with seeded random weights (the same draws for either)."""
    slices = tsc.TscObsSlices(*slices_args)
    g = torch.Generator().manual_seed(11)
    ac = nets.flax_init_(tsc.ActorCriticTSC(slices, e.num_actions_d, e.num_actions_c), g)
    est = nets.flax_init_(nets.Estimator(slices.n_prop_hist, e.n_priv), g)
    bbc = nets.flax_init_(nets.ActorCritic(nets.ObsSlices(57, 4, 29, 10, 11), num_actions=12), g)
    return ac, est, bbc.eval().requires_grad_(False)


def _make(env_mod, smoke_cfg, nets, tsc, vis):
    env = env_mod.Go2AgilityEnv(smoke_cfg(N, COURSES), "cpu", seed=3)
    e = env.cfg.env
    args = (e.n_proprio, e.n_scan, e.n_priv, e.n_priv_latent, e.history_len, e.n_auxiliary)
    return vis.TscVision(env, *_nets(nets, tsc, args, e), CFG, seed=SEED)


@pytest.fixture(scope="module")
def pair():
    """(port, reference) student trainers, each on its own env from the same
    seed, and the port env's state a few steps into its course."""
    port = _make(tenv, tsc_smoke_cfg, tnets, ttsc, tvis)
    ref = _make(renv, rcfg.tsc_smoke_cfg, rnets, rtsc, rvis)
    es = port.env.init_state()
    g = torch.Generator().manual_seed(2)
    for _ in range(3):
        hl = torch.cat([torch.randint(0, 3, (N, 1), generator=g).float(),
                        0.3 * torch.randn(N, 18, generator=g)], -1)
        es2, nc = port.env.set_commands(es, hl)
        es, _ = port.env.step(es2, 0.2 * torch.randn(N, 12, generator=g))
    return port, ref, es


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def _ref_draws(d):
    return rvis.VisionDraws(rrc.DepthNoise(*d.depth), d.byol_idx, rdepth.AugmentDraws(*d.aug1),
                            rdepth.AugmentDraws(*d.aug2))


def test_initial_weights_and_pitches_match(pair):
    port, ref, _ = pair
    for name in ("_enc0", "_byol0"):
        a, b = _params(getattr(port, name)), _params(getattr(ref, name))
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    _same(port.cam_pitch, ref.cam_pitch)


def test_render_and_process_match_under_the_crossing_rule(pair):
    port, ref, es = pair
    w = port.env._weights(es)
    args = (es.sim.base_pos, es.sim.base_quat, port.cam_pitch, w)
    noise = trc.draw_depth_noise(torch.Generator().manual_seed(4), N, *port.image_shape)
    d_p = trc.render_depth(port.cam, port.env.grid, *args)
    d_r = rrc.render_depth(ref.cam, ref.env.grid, *args)
    keep = rrc.crossing_mask(ref.cam, ref.env.grid, *args)
    _same(keep, trc.crossing_mask(port.cam, port.env.grid, *args))
    assert float((~keep).float().mean()) <= LEFT_OUT
    _same(d_p[keep], d_r[keep])
    assert bool(((d_r > port.cam.near) & (d_r < port.cam.far)).any())   # something is seen
    p_p = trc.process_depth(d_p, port.cam.near, port.cam.far, noise)
    p_r = rrc.process_depth(d_r, ref.cam.near, ref.cam.far, rrc.DepthNoise(*noise))
    _same(p_p[keep], p_r[keep])


def test_encoder_step_matches(pair):
    port, ref, es = pair
    g = torch.Generator().manual_seed(6)
    depth = torch.rand((N,) + port.image_shape, generator=g) - 0.5
    hidden = torch.randn(N, 512, generator=g)
    _, prop = port._prep_obs(es)
    _, prop_r = ref._prep_obs(es)
    _same(prop, prop_r)
    with torch.no_grad():
        outs_p = port._encode(copy.deepcopy(port._enc0), depth, prop, hidden)
        outs_r = ref._encode(copy.deepcopy(ref._enc0), depth, prop, hidden)
    for a, b in zip(outs_p, outs_r):
        _same(a, b)
    assert float(outs_p[3].abs().sum()) > 0            # the GRU state moved


def test_update_with_byol_matches(pair):
    """One distillation update and the BYOL minibatches on the same rollout
    data and draws: the losses, each network's last gradients and the
    parameters after."""
    port, ref, es = pair
    ts_p, ts_r = port.init_train_state(), ref.init_train_state()
    draws = port.draw()
    ref.draw()                                   # keep the generators in step
    _, data, _, _ = port.rollout(ts_p, es, draws.depth)
    data_r = rvis.VisionData(*(x.clone() if torch.is_tensor(x) else x for x in data))
    m_p = port.update(ts_p, data, draws)
    m_r = ref.update(ts_r, data_r, _ref_draws(draws))
    assert m_p.keys() == m_r.keys()
    for k in m_p:
        _same(m_p[k], m_r[k])
    for name in ("enc", "actor", "byol", "byol_target"):
        a, b = getattr(ts_p, name), getattr(ts_r, name)
        for (k, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
            _same(pa, pb)
            if pa.grad is not None or pb.grad is not None:
                _same(pa.grad, pb.grad)
    moved = [k for k, v in _params(ts_p.enc).items() if not torch.equal(v, _params(port._enc0)[k])]
    assert moved                                  # the update did something


@pytest.fixture(scope="module")
def iteration(pair):
    """One whole iteration on each package's own env from the same state and
    draws, the port's with tracing on: (port's and reference's (ts, env
    state, metrics), the port's span records, its counters' increments)."""
    port, ref, _ = pair
    port.env.gen.manual_seed(9)
    ref.env.gen.manual_seed(9)
    es_p, es_r = port.env.init_state(), ref.env.init_state()
    _same(es_p.obs_buf, es_r.obs_buf)
    ts_p, ts_r = port.init_train_state(), ref.init_train_state()
    draws = port.draw()
    ref.draw()
    counts0 = dict(vars(trc.RENDER)), dict(vars(tdepth.BYOL))
    trace.disable()
    trace.reset()
    trace.enable("cpu")
    try:
        out_p = port.train_iteration(ts_p, es_p, draws)
    finally:
        trace.disable()
    records = trace.records()
    trace.reset()
    counts = ({k: v - counts0[0][k] for k, v in vars(trc.RENDER).items()},
              {k: v - counts0[1][k] for k, v in vars(tdepth.BYOL).items()})
    out_r = ref.train_iteration(ts_r, es_r, _ref_draws(draws))
    return out_p, out_r, records, counts


def test_train_iteration_with_injected_draws_matches(iteration):
    """The metrics, the new env state, the GRU state, the parameters (the
    port's spans on: they change nothing)."""
    (ts_p, es_p, m_p), (ts_r, es_r, m_r), _, _ = iteration
    for k in m_p:
        _same(m_p[k], m_r[k])
    for f in ("obs_buf", "obs_bbc_buf", "delta_yaw"):
        _same(getattr(es_p, f), getattr(es_r, f))
    _same(es_p.sim.base_pos, es_r.sim.base_pos)
    _same(ts_p.hidden, ts_r.hidden)
    for name in ("enc", "actor", "byol"):
        for pa, pb in zip(getattr(ts_p, name).parameters(), getattr(ts_r, name).parameters()):
            _same(pa, pb)


def test_student_spans_and_counters(pair, iteration):
    """Tracing on: the render, encode, update and BYOL spans under their
    trainer stages, and the counters; tracing off: no record, the counters
    still count."""
    port, _, es = pair
    _, _, records, (render, byol) = iteration
    T, interval = CFG.num_steps_per_env, port.env.cfg.depth.update_interval
    R, (H, W) = -(-T // interval), port.image_shape
    parents = {}
    for r in records:
        parents.setdefault(r.name, set()).add(r.parent)
    assert parents["render.march"] == parents["render.crossing"] == {"train.render"}
    assert parents["vision.encode"] == {"train.encode", "vision.losses"}
    for name in ("vision.losses", "vision.backward", "vision.optim"):
        assert parents[name] == {"train.update"}
    for name in ("byol.augment", "byol.step", "byol.ema"):
        assert parents[name] == {"train.byol"}
    count = lambda n: sum(r.name == n for r in records)
    assert count("render.march") == R and count("vision.encode") == 2 * R
    assert count("vision.losses") == 1 and count("byol.step") == CFG.byol_minibatches
    assert render == dict(calls=R, rays=R * N * H * W, samples=R * N * H * W * 32)
    assert byol == dict(minibatches=CFG.byol_minibatches,
                        images=CFG.byol_minibatches * max(1, R * N // CFG.byol_minibatches))

    samples = trc.RENDER.samples
    noise = trc.draw_depth_noise(torch.Generator().manual_seed(4), N, H, W)
    img = port.render(es, noise)
    ts = port.init_train_state()
    tdepth.byol_loss(ts.byol, ts.byol_target, img, img)
    assert trace.records() == []
    assert trc.RENDER.samples - samples == N * H * W * 32


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmark.reference import vision\n"
            "from benchmark.reference.plain.render import raycast\n"
            "from benchmark.reference.plain.learn import depth, vision_tsc\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'agility_tpu', 'agility_tpu_torch'})))\n") % ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
