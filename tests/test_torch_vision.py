"""The port's depth student (render/raycast.py, learn/depth.py,
learn/vision_tsc.py and the vision half of io/checkpoint.py) against the
JAX package on the CPU, from the same numpy inputs and parameters (carried
across with io/checkpoint.params_from_jax_vision and its helpers), the JAX
key chain's draws injected into the port.

The first crossing of a ray is discontinuous in the sampled heights: where
a march sample's clearance lies within rounding of zero, a float32
difference moves the crossing by a whole sample (0.119 m).  The clearances
of the two packages differ by up to 6.1e-5 m on tall surfaces (the grid
coordinate (x - origin) / hscale, up to 480 cells, is one ulp apart, 3e-5
cells, where a cell's height or ceiling jumps by metres), and the secant
step magnifies a clearance difference by (t1 - t0) f0 / (f1 - f0)^2 where
a ray grazes a surface.  Depth is therefore compared on the pixels whose
clearances up to the crossing are all at least raycast.CROSSING_EPS (1e-4
m) from zero and
whose crossing no ceiling edge decides (raycast.crossing_mask: there the
bilinear blend of the 100 m open-sky sentinel with the roof makes one ulp
of the grid coordinate worth up to 3e-3 m), the pixels left out counted
and held few, at DEPTH_TOL in the worst pixel and DEPTH_P99 in the 99th
percentile.  The rollout is replayed from recorded port env steps
(tests/test_torch_train_iteration.py's _Replay), so the JAX SoA engine is
never compiled.  Tolerances are stated per test with the error measured on
this CPU.
"""
import os
import types

import flax.serialization as ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agility_tpu.envs import go2_agility as jenv
from agility_tpu.io import checkpoint as jckpt
from agility_tpu.learn import depth as jdepth
from agility_tpu.learn import ppo_tsc as jppo
from agility_tpu.learn import vision_tsc as jvis
from agility_tpu.render import raycast as jrc
from agility_tpu_torch.core import quat as tq
from agility_tpu_torch.envs import go2_agility as tenv
from agility_tpu_torch.io import checkpoint as tckpt
from agility_tpu_torch.learn import depth as tdepth
from agility_tpu_torch.learn import ppo_tsc as tppo
from agility_tpu_torch.learn import vision_tsc as tvis
from agility_tpu_torch.physics import heightfield as thf
from agility_tpu_torch.render import raycast as trc
from agility_tpu_torch.terrain import obstacle as tobst
from test_torch_train import _t
from test_torch_train_iteration import _Replay
from test_torch_tsc_train import BBC_CKPT, KW, N, _cfgs, one_thread, state_to_jax  # noqa: F401

DEPTH_TOL = 1e-3      # [m] worst kept pixel (a grazing ray's secant step; measured 3.0e-4)
DEPTH_P99 = 1e-5      # [m] 99th percentile of the kept pixels (measured 4.9e-6)
SMALL = (20, 30)      # tests/test_vision.py's image size, (H, W)


def _np(x):
    return np.asarray(x)


def _rel(g, w):
    g, w = np.ravel(np.asarray(g, np.float64)), np.ravel(np.asarray(w, np.float64))
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-3))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)])


def _perturb(tree, seed, scale=0.05):
    """Every leaf of a flax tree plus N(0, scale) noise (so biases and the
    BatchNorm statistics are not their initial zeros and ones); `var`
    leaves stay positive."""
    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, x in paths:
        y = np.asarray(x) + rng.normal(0, scale, np.shape(x)).astype(np.float32)
        if str(path[-1].key) == "var":
            y = np.abs(y) + 0.5
        out.append(jnp.asarray(y))
    return jax.tree_util.tree_unflatten(treedef, out)


def _load(module, sd):
    module.load_state_dict(sd)
    return module


def _unprefix(sd):
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# the camera and the ray-march
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def envs():
    """(JAX env, port env) on the 8-env, 2-course smoke world."""
    jc, tc = _cfgs()
    return jenv.Go2AgilityEnv(jc), tenv.Go2AgilityEnv(tc, "cpu", seed=0)


SCENES = ("bar_jump", "bar_jump", "tunnel", "tunnel", "seesaw", "seesaw", "tire_jump", "frame")


def placed(te, s, seed=0):
    """State `s` with env e at the approach goal of the SCENES[e] station of
    its course, facing the obstacle (in the tunnel: at its middle goal,
    under the roof), 0.3 m over the folded floor, with a small random roll
    and pitch, random bar and tire heights and a random plank tilt; the
    even envs' current goal is the one they face."""
    rng = np.random.default_rng(seed)
    pos, yaw = np.zeros((N, 3), np.float32), np.zeros(N, np.float32)
    goal = s.cur_goal_idx.clone()
    for e, kind in enumerate(SCENES):
        station = int(np.argmax(te.obst_types[e].numpy() == tobst.OBST_TYPES.index(kind)))
        g = station * te.num_goals + (2 if kind == "tunnel" else 1)
        a, b = te.env_goals[e, g, :2].numpy(), te.env_goals[e, g + 1, :2].numpy()
        pos[e, :2] = a
        yaw[e] = np.arctan2(b[1] - a[1], b[0] - a[0])
        if e % 2 == 0:
            goal[e] = g + 1
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    s = s._replace(bar_h=f32(rng.uniform(0.05, 0.3, N)), tire_h=f32(rng.uniform(0.4, 0.65, N)),
                   seesaw_theta=f32(rng.uniform(-1, 1, N) * tobst.SEESAW_THETA_MAX),
                   cur_goal_idx=goal)
    s = s._replace(cur_goals=te._gather_goals(s, goal), next_goals=te._gather_goals(s, goal + 1))
    floor = thf.sample_height(te.grid, f32(pos[:, 0]), f32(pos[:, 1]), te._weights(s))
    pos[:, 2] = floor.numpy() + 0.3
    rp = rng.normal(0, 0.05, (2, N)).astype(np.float32)
    quat = tq.quat_from_euler_xyz(f32(rp[0]), f32(rp[1]), f32(yaw))
    return s._replace(sim=s.sim._replace(base_pos=f32(pos), base_quat=quat))


def jax_render(je, jcam, pos, quat, pitch, w):
    return jax.jit(jax.vmap(lambda bp, bq, cp, wi: jrc.render_depth(jcam, je.grid, bp, bq, cp, wi))
                   )(*(jnp.asarray(_np(x)) for x in (pos, quat, pitch, w)))


def check_depth(err, keep, scale=1.0):
    """Depth errors (metres x `scale`) held to the crossing rule."""
    e = err[keep.numpy()]
    assert e.max() < DEPTH_TOL * scale, e.max()
    assert np.percentile(e, 99) < DEPTH_P99 * scale, np.percentile(e, 99)
    assert (~keep).sum() <= 5e-3 * keep.numel(), int((~keep).sum())


def test_make_camera_matches():
    """The camera's ray directions and mount offset equal the JAX camera's
    (the same numpy computation); the march distances are its linspace's
    within one float32 ulp (jnp.linspace rounds differently)."""
    for kw in ({}, dict(width=30, height=20, n_steps=64)):
        j, t = jrc.make_camera(**kw), trc.make_camera(device="cpu", **kw)
        np.testing.assert_array_equal(t.dirs.numpy(), _np(j.dirs))
        np.testing.assert_array_equal(t.offset.numpy(), _np(j.offset))
        assert (t.width, t.height, t.near, t.far, t.n_steps) == (
            j.width, j.height, j.near, j.far, j.n_steps)
        np.testing.assert_allclose(t.ts.numpy(), _np(jnp.linspace(j.near, j.far, j.n_steps)),
                                   rtol=0, atol=4.8e-7)


def test_render_depth_matches(envs):
    """render_depth of 8 envs on the smoke world (two before a bar, two in
    the tunnel under its roof, two before the seesaw with the plank tilted,
    one before the tire, one before the frame; random bar and tire heights,
    camera pitch within +-5 deg) against the JAX vmapped render_depth.  The
    scenes are checked to reach the surfaces: the roof (ceiling rows), the
    bar's layer offset and the plank's tilt each change depth.  Measured:
    53 of 40,368 pixels excluded, max |port - JAX| 3.0e-4 m over the pixels
    kept (a ray starting under the tilted plank, secant-extrapolated),
    99th percentile 4.9e-6 m; held at DEPTH_TOL and DEPTH_P99, exclusions
    at most 0.5%."""
    je, te = envs
    s = placed(te, te.init_state())
    jcam, tcam = jrc.make_camera(), trc.make_camera(device="cpu")
    pitch = torch.deg2rad(torch.as_tensor(np.random.default_rng(1).uniform(-5, 5, N),
                                          dtype=torch.float32))
    pos, quat, w = s.sim.base_pos, s.sim.base_quat, te._weights(s)
    got = trc.render_depth(tcam, te.grid, pos, quat, pitch, w)
    want = _np(jax_render(je, jcam, pos, quat, pitch, w))
    keep = trc.crossing_mask(tcam, te.grid, pos, quat, pitch, w)
    check_depth(np.abs(got.numpy() - want), keep)
    assert float(got.min()) < 1.5 and float((got < tcam.far).float().mean()) > 0.3

    def changed(grid=te.grid, weights=w):
        d = trc.render_depth(tcam, grid, pos, quat, pitch, weights)
        return (torch.abs(d - got) > 1e-3).flatten(1).any(-1)

    roof = changed(grid=te.grid._replace(ceiling=None))
    bar = changed(weights=w * torch.tensor([0.0, 1.0, 1.0]))
    tilt = changed(weights=w * torch.tensor([1.0, 1.0, 0.0]))
    assert bool(roof[2]) and bool(roof[3]), roof
    assert bool(bar[0]) and bool(bar[1]), bar
    assert bool(tilt[4]) and bool(tilt[5]), tilt


def test_process_depth_matches(rng):
    """process_depth fed the uniforms of the JAX per-env key split (level,
    offset, per-pixel): clip, normalise and noise; measured 0 (bit-equal),
    held at 1e-6."""
    H, W = SMALL
    depth = rng.uniform(0.0, 5.0, (N, H, W)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    want = jax.vmap(lambda k, d: jrc.process_depth(k, d, 0.3, 4.0, 0.05))(keys, jnp.asarray(depth))
    noise = depth_noise(keys, H, W)
    got = trc.process_depth(torch.as_tensor(depth), 0.3, 4.0, noise, 0.05)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    assert float(noise.pixel.std()) > 0.2


def depth_noise(keys, H, W):
    """The port's DepthNoise from the JAX per-env keys (process_depth's
    split into level, offset and per-pixel)."""
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    u = jax.vmap(lambda k: jax.random.uniform(k))
    return trc.DepthNoise(_t(u(ks[:, 0])), _t(u(ks[:, 1])),
                          _t(jax.vmap(lambda k: jax.random.uniform(k, (H, W)))(ks[:, 2])))


# ---------------------------------------------------------------------------
# the depth networks
# ---------------------------------------------------------------------------


def _stack_encoder(p):
    """StackDepthEncoder's state dict from its flax params."""
    sd = tckpt._backbone(p["DepthBackbone58x87_0"], "backbone")
    sd.update(tckpt._dense(p["Dense_0"], "combine.layers.0"))
    sd.update(tckpt._dense(p["Dense_1"], "combine.layers.1"))
    sd.update(tckpt._conv(p["Conv_0"], "conv0"))
    sd.update(tckpt._conv(p["Conv_1"], "conv1"))
    sd.update(tckpt._dense(p["Dense_2"], "out"))
    return sd


@pytest.mark.parametrize("net", ["backbone", "recurrent", "stack", "byol"])
def test_depth_nets_match_flax(net, rng, request):
    """Each depth net's forward pass from one perturbed flax parameter tree:
    the backbone and the recurrent encoder at 58 x 87 (62,400 inputs to the
    first Dense, which a CHW flatten would scramble), the frame-stack
    encoder (buffer 2, SAME-padded strided conv) and BYOL (project and
    predict, sums over 4096 units, outputs up to ~10) at 20 x 30.  float32,
    other summation orders; held at 1e-5 relative + 1e-5 x the output's
    largest magnitude absolute.  Measured, as max |port - JAX| over that
    magnitude: 1.6e-6 (backbone), 1.0e-6 (recurrent outputs) and 5.8e-6
    (its GRU state), 5.4e-7 (stack), 8.3e-7 (BYOL)."""
    B = 6
    shape = (58, 87) if net in ("backbone", "recurrent") else SMALL
    img = rng.uniform(-0.5, 0.5, (B,) + shape).astype(np.float32)
    prop = rng.normal(0, 1.0, (B, 65)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ji, ti = jnp.asarray(img), torch.as_tensor(img)
    with torch.no_grad():
        if net == "backbone":
            jm = jdepth.DepthBackbone58x87()
            v = _perturb(jm.init(key, ji), 0)
            tm = _load(tdepth.DepthBackbone58x87(), _unprefix(tckpt._backbone(v["params"], "b")))
            pairs = [(tm(ti), jm.apply(v, ji))]
        elif net == "recurrent":
            jm = jdepth.RecurrentDepthEncoder()
            h = rng.normal(0, 0.3, (B, 512)).astype(np.float32)
            v = _perturb(jm.init(key, ji, jnp.asarray(prop), jnp.zeros((B, 512))), 1)
            tm = _load(tdepth.RecurrentDepthEncoder(), tckpt._encoder(v["params"]))
            pairs = list(zip(tm(ti, torch.as_tensor(prop), torch.as_tensor(h)),
                             jm.apply(v, ji, jnp.asarray(prop), jnp.asarray(h))))
            pairs.append((tm.embed_image(ti), jm.apply(v, ji, method="embed_image")))
        elif net == "stack":
            stack = rng.uniform(-0.5, 0.5, (B, 2) + shape).astype(np.float32)
            jm = jdepth.StackDepthEncoder()
            v = _perturb(jm.init(key, jnp.asarray(stack), jnp.asarray(prop)), 2)
            tm = _load(tdepth.StackDepthEncoder(image_shape=shape), _stack_encoder(v["params"]))
            pairs = [(tm(torch.as_tensor(stack), torch.as_tensor(prop)),
                      jm.apply(v, jnp.asarray(stack), jnp.asarray(prop)))]
        else:
            jv = request.getfixturevalue("visions").jv
            jm, v = jv.byol_net, _perturb(jv._byol_state0.online, 3)
            tm = _load(tdepth.BYOLNets(image_shape=shape), tckpt._byol(v))
            pairs = [(tm(ti), jm.apply(v, ji)), (tm.project(ti), jm.apply(v, ji, method="project"))]
    for g, w in pairs:
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5 * scale)


def _byol_pair(jv, seed):
    """(flax net, online, target variables), the JAX student's initial BYOL
    variables (20 x 30 images) perturbed apart, and the port's online and
    target BYOLNets holding them."""
    st = jv._byol_state0
    on, tg = _perturb(st.online, seed), _perturb(st.online, seed + 100)
    mk = lambda v: _load(tdepth.BYOLNets(image_shape=SMALL), tckpt._byol(v))
    return jv.byol_net, on, tg, mk(on), mk(tg)


def test_byol_loss_and_grads_match(visions, rng):
    """byol_loss and its gradient over the whole online variables dict,
    batch_stats included (the JAX trainer takes value_and_grad over
    st.online, so Adam trains the BatchNorm mean and var): the port's
    FixedNorm holds them as parameters.  Measured: loss 1.1e-7 relative,
    gradients 4.9e-7 (params) and 3.7e-7 (batch_stats) as the norm of the
    difference over the norm, |grad| of mean and var up to 0.014; held at
    1e-5 and 1e-4."""
    jnet, on, tg, ton, ttg = _byol_pair(visions.jv, 4)
    a1, a2 = (rng.uniform(-0.5, 0.5, (8,) + SMALL).astype(np.float32) for _ in range(2))
    jl, jg = jax.value_and_grad(lambda v: jdepth.byol_loss(jnet, v, tg, jnp.asarray(a1),
                                                           jnp.asarray(a2)))(on)
    tl = tdepth.byol_loss(ton, ttg, torch.as_tensor(a1), torch.as_tensor(a2))
    tl.backward()
    assert all(p.grad is None for p in ttg.parameters())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = tckpt._to_byol({k: p.grad for k, p in ton.named_parameters()})
    for part in ("params", "batch_stats"):
        assert _rel(_flat(got[part]), _flat(jg[part])) < 1e-4, part
    assert float(np.abs(_flat(jg["batch_stats"])).max()) > 1e-3


def test_byol_ema_update_matches(visions):
    """The EMA over every online variable, batch_stats included, decay
    0.99 in float32: measured 0 (bit-equal); held at 1e-7."""
    _, on, tg, ton, ttg = _byol_pair(visions.jv, 5)
    want = jdepth.byol_ema_update(jdepth.BYOLState(on, tg, jnp.asarray(0.99, jnp.float32))).target
    tdepth.byol_ema_update(ton, ttg, torch.tensor(0.99))
    got = tckpt._to_byol(ttg.state_dict())
    np.testing.assert_allclose(_flat(got), _flat(want), rtol=0, atol=1e-7)


def augment_draws(keys, H, W):
    """The port's AugmentDraws from augment_depth's per-image JAX keys."""
    def one(key):
        ks = jax.random.split(key, 8)
        kb = jax.random.split(ks[1], 5)
        u = jnp.stack([jax.random.uniform(ks[i]) for i in (0, 2, 4, 6)])
        box = jnp.stack([jax.random.randint(kb[0], (), 1, H // 4),
                         jax.random.randint(kb[1], (), 1, W // 4),
                         jax.random.randint(kb[2], (), 0, 3 * H // 4),
                         jax.random.randint(kb[3], (), 0, 3 * W // 4)])
        return (u, box, jax.random.uniform(kb[4], (H, W)), jax.random.normal(ks[3], (H, W)),
                jax.random.uniform(ks[5], (H, W)))
    u, box, bg, gauss, drop = jax.vmap(one)(keys)
    return tdepth.AugmentDraws(_t(u), _t(box).long(), _t(bg), _t(gauss), _t(drop))


def test_augment_depth_matches(rng):
    """augment_depth on 64 images from JAX keys: 56 random keys and 8 keys
    with every branch forced on (background patch, gaussian noise, pixel
    dropout, blur, found by searching 400,000 keys: 19 hits), the port fed
    their draws.  Measured 0 (bit-equal); held at 1e-6."""
    H, W = SMALL
    ks = jax.random.split(jax.random.PRNGKey(0), 400_000)
    flags = jax.vmap(lambda k: jnp.stack([jax.random.uniform(s) for s in
                                          jax.random.split(k, 8)[jnp.array([0, 2, 4, 6])]]))(ks)
    all_on = np.flatnonzero(np.all(_np(flags) < np.array([0.1, 0.1, 0.05, 0.1]), axis=1))
    assert len(all_on) >= 8
    keys = jnp.concatenate([ks[jnp.asarray(all_on[:8])], ks[:56]])
    img = rng.uniform(-0.5, 0.5, (64, H, W)).astype(np.float32)
    want = jax.vmap(jdepth.augment_depth)(keys, jnp.asarray(img))
    draws = augment_draws(keys, H, W)
    got = tdepth.augment_depth(torch.as_tensor(img), draws)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    assert bool((draws.apply[:8] < torch.tensor([0.1, 0.1, 0.05, 0.1])).all())
    assert not np.allclose(_np(want[:8]), img[:8])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

VCFG = dict(num_steps_per_env=8, byol_minibatches=2)   # T = 8: chunks of 5 and 3


@pytest.fixture(scope="module")
def visions():
    """The JAX TscVision `jv` (and its jitted `update`), the port's `tv`
    and the JAX teacher state `jts` on the 8-env,
    2-course smoke world with 20 x 30 images, the frozen BBC of
    bbc_final.msgpack and the JAX teacher's initial parameters; the port
    holds the JAX student's initial encoder, BYOL nets and camera pitch."""
    over = {"depth.resized": (SMALL[1], SMALL[0])}
    jc, tc = _cfgs(**over)
    bbc = tckpt.load_bbc_frozen(BBC_CKPT)
    # the JAX BBCFrozen carried from the port's (flax's eager init in
    # runner_tsc.load_bbc_frozen costs ~16 s here)
    trees = tckpt.params_to_jax(bbc.ac, bbc.est, bbc.disc)
    jbbc = jppo.BBCFrozen(*(jax.tree.map(jnp.asarray, trees[k])
                            for k in ("ac_params", "est_params", "disc_params")),
                          disc_norm={k: jnp.asarray(v.numpy()) for k, v in bbc.disc_norm.items()})
    ja = jppo.TscPPO(jenv.Go2AgilityEnv(jc), jbbc, jppo.TscAlgoCfg(**KW), seed=0)
    jts = ja.init_train_state(jax.random.PRNGKey(1))
    ta = tppo.TscPPO(tenv.Go2AgilityEnv(tc, "cpu", seed=0), bbc, tppo.TscAlgoCfg(**KW), seed=0)
    sd = tckpt.params_from_jax_tsc({"ac_params": jts.ac_params, "est_params": jts.est_params})
    tac, test = ta._ac0, ta._est0
    tac.load_state_dict(sd["actor_critic"])
    test.load_state_dict(sd["estimator"])
    jv = jvis.TscVision(ja.env, ja, jts.ac_params, jts.est_params, jvis.VisionCfg(**VCFG), seed=0)
    tv = tvis.TscVision(ta.env, tac, test, ta.bbc_ac, tvis.VisionCfg(**VCFG), seed=0)
    tv._enc0.load_state_dict(tckpt._encoder(jv._enc_params0["params"]))
    tv._byol0.load_state_dict(tckpt._byol(jv._byol_state0.online))
    tv.cam_pitch = _t(jv.cam_pitch)
    return types.SimpleNamespace(jv=jv, tv=tv, jts=jts, update=jax.jit(jv.update))


def student_errors(ts, jts):
    """{tree: ||port - JAX|| / ||JAX||} over the encoder, the student
    actor-critic and the BYOL online and target variables."""
    got = tckpt.params_to_jax_vision(ts.enc.state_dict(), ts.actor.state_dict(),
                                     ts.byol.state_dict(), ts.byol_target.state_dict())
    return {"enc": _rel(_flat(got["enc_params"]), _flat(jts.enc_params)),
            "actor": _rel(_flat(got["actor_params"]), _flat(jts.actor_params)),
            "byol_online": _rel(_flat(got["byol_online"]), _flat(jts.byol_state.online)),
            "byol_target": _rel(_flat(got["byol_target"]), _flat(jts.byol_state.target))}


def rollout_noise(jv, key, T, interval, H, W):
    """The depth noise of the JAX rollout's key chain: per chunk `key,
    k_depth = split(key)` and render's split of k_depth into N keys, then
    one split per control step."""
    noise = []
    for t0 in range(0, T, interval):
        key, k_depth = jax.random.split(key)
        noise.append(depth_noise(jax.random.split(k_depth, N), H, W))
        for _ in range(min(interval, T - t0)):
            key, _ = jax.random.split(key)
    return trc.DepthNoise(*(torch.stack(x) for x in zip(*noise))), key


def test_vision_rollout_matches(visions, monkeypatch):
    """The student rollout over two camera chunks (T = 8: 5 + 3), both
    sides replaying the same recorded port env steps (zero actions, from
    the placed scenes' states) with set_commands real on each side and
    the port fed the JAX key chain's depth noise.  Checked: the refresh
    images (crossing rule), the masked proprio, the stored observations
    (estimator written in), the dyaw-ok mask, the teacher's modes and
    means, the GRU state after both refreshes and the metrics.  Measured:
    images 3.7e-5 m at worst and 4.0e-6 m at the 99th percentile over the
    pixels kept (19 of 9,600 excluded), proprio 0, obs 2.2e-7, the
    teacher's means 4.2e-7, the GRU state 9.0e-6 (fed by the images'
    differences), metrics 3.7e-9, 22 of 64 steps dyaw-ok; images held to
    the crossing rule (in normalised units), obs and means at 1e-5
    relative + 1e-5, the GRU state at 5e-5."""
    jv, tv = visions.jv, visions.tv
    te = tv.env
    T, interval = VCFG["num_steps_per_env"], te.cfg.depth.update_interval
    es0 = placed(te, te.init_state(), seed=2)
    states, outs, s = [], [], es0
    for _ in range(T):
        s, out = te.step(s, torch.zeros(N, 12))
        states.append(s)
        outs.append(out)
    g0 = es0.global_counter
    jstates = [state_to_jax(x) for x in states]
    jouts = [jenv.TscStepOutput(*(jnp.asarray(getattr(o, f).numpy())
                                  for f in jenv.TscStepOutput._fields)) for o in outs]
    stacked = (jax.tree.map(lambda *x: jnp.stack(x), *jstates),
               jax.tree.map(lambda *x: jnp.stack(x), *jouts))
    monkeypatch.setattr(jv, "env", _Replay(jv.env, g0, lambda t: jax.tree.map(
        lambda x: x[t], stacked)))
    monkeypatch.setattr(tv, "env", _Replay(te, g0, lambda t: (states[t], outs[t])))

    jvts = jv.init_train_state(jax.random.PRNGKey(1))
    tvts = tv.init_train_state()
    H, W = tv.image_shape
    noise, _ = rollout_noise(jv, jvts.key, T, interval, H, W)
    _, _, jdata, jhidden, jm = jax.jit(jv.rollout)(jvts, state_to_jax(es0))
    _, data, hidden, tm = tv.rollout(tvts, es0, noise)

    assert data.chunks == ((0, 5), (5, 3))
    keep = torch.stack([trc.crossing_mask(tv.cam, te.grid, x.sim.base_pos, x.sim.base_quat,
                                      tv.cam_pitch, te._weights(x)) for x in (es0, states[4])])
    far = te.cfg.depth.far_clip - te.cfg.depth.near_clip
    check_depth(np.abs(data.depth.numpy() - _np(jdata["depth"])), keep, 1.0 / far)
    np.testing.assert_allclose(data.prop_masked.numpy(), _np(jdata["prop_masked"]), atol=1e-6)
    cat = lambda k: np.concatenate([_np(c[k]) for c in jdata["chunks"]])
    np.testing.assert_allclose(data.obs.numpy(), cat("obs"), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(data.dyaw_ok.numpy(), cat("dyaw_ok"))
    assert 0 < int(data.dyaw_ok.sum()) < T * N
    a0 = tv.n_prop - tv.n_aux
    np.testing.assert_array_equal(data.obs[..., a0:a0 + 2].numpy(), cat("teacher_dyaw"))
    np.testing.assert_array_equal(data.obs[..., a0 + 2:tv.n_prop].numpy(), cat("teacher_types"))
    at, jat = data.actions_teacher.numpy(), cat("actions_teacher")
    np.testing.assert_array_equal(at[..., 0], jat[..., 0])
    np.testing.assert_allclose(at, jat, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hidden.numpy(), _np(jhidden), rtol=0, atol=5e-5)
    assert float(torch.abs(hidden).max()) > 1e-2
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def update_inputs(jv, seed=0, T=8):
    """A rollout's data as the JAX rollout stores it, made from a seed:
    refresh images, masked proprio, and per chunk the observations (their
    delta-yaw and one-hot obstacle columns as the teacher's targets), the
    dyaw-ok mask and the teacher's actions."""
    rng = np.random.default_rng(seed)
    H, W = SMALL
    interval = jv.env.cfg.depth.update_interval
    a0 = jv.n_prop - jv.n_aux
    chunks = [min(interval, T - t0) for t0 in range(0, T, interval)]
    R = len(chunks)
    prop = rng.normal(0, 0.5, (R, N, jv.n_prop)).astype(np.float32)
    prop[..., a0:] = 0.0
    data = {"depth": jnp.asarray(rng.uniform(-0.5, 0.5, (R, N, H, W)).astype(np.float32)),
            "prop_masked": jnp.asarray(prop), "chunks": []}
    for steps in chunks:
        obs = rng.normal(0, 0.5, (steps, N, jv.slices.total)).astype(np.float32)
        obs[..., a0 + 2:jv.n_prop] = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (steps, N))]
        at = rng.normal(0, 0.5, (steps, N, 19)).astype(np.float32)
        at[..., 0] = rng.integers(0, 3, (steps, N))
        data["chunks"].append(dict(
            obs=jnp.asarray(obs), dyaw_ok=jnp.asarray(rng.random((steps, N)) < 0.7),
            actions_teacher=jnp.asarray(at), teacher_dyaw=jnp.asarray(obs[..., a0:a0 + 2]),
            teacher_types=jnp.asarray(obs[..., a0 + 2:jv.n_prop])))
    return data


def port_data(jdata):
    cat = lambda k: _t(jnp.concatenate([c[k] for c in jdata["chunks"]]))
    steps = [c["obs"].shape[0] for c in jdata["chunks"]]
    return tvis.VisionData(depth=_t(jdata["depth"]), prop_masked=_t(jdata["prop_masked"]),
                           obs=cat("obs"), dyaw_ok=cat("dyaw_ok"),
                           actions_teacher=cat("actions_teacher"),
                           chunks=tuple((sum(steps[:i]), s) for i, s in enumerate(steps)))


def update_draws(key, M, n, H, W):
    """BYOL's draws of the JAX update's key chain (`key, sub = split(key)`,
    one key per minibatch, each split into the indices and the two
    augmentations' per-image keys)."""
    _, sub = jax.random.split(key)
    mb = max(1, n // M)
    idx, aug1, aug2 = [], [], []
    for k in jax.random.split(sub, M):
        k1, k2, k3 = jax.random.split(k, 3)
        idx.append(_t(jax.random.randint(k1, (mb,), 0, n)).long())
        aug1.append(augment_draws(jax.random.split(k2, mb), H, W))
        aug2.append(augment_draws(jax.random.split(k3, mb), H, W))
    st = lambda a: tdepth.AugmentDraws(*(torch.stack(x) for x in zip(*a)))
    return torch.stack(idx), st(aug1), st(aug2)


@pytest.mark.parametrize("it", [0, 15000])
def test_vision_update_matches(visions, it):
    """update on one rollout's data (two chunks, 5 + 3 steps) at it = 0 and
    it = 15000 (learning rates 1e-3 / 2.6e-4, BYOL's 3e-4 / 8.3e-5), from
    the JAX student's initial parameters with a nonzero iteration-start
    GRU state, the port fed the JAX key chain's BYOL draws: the four
    losses, the learning rate, and the encoder, the student actor-critic
    (its critic and scan encoder untouched) and BYOL's online and target
    variables afterwards.  Measured (it = 0 / 15000): losses 1.3e-7 /
    1.3e-7 relative, parameters 9.0e-7 / 2.3e-7 (encoder), 6.4e-7 / 1.7e-7
    (student), 4.7e-7 / 1.2e-7 (BYOL online), 5.3e-8 / 4.6e-8 (target), as
    the norm of the difference over the norm; held at 1e-5."""
    jv, tv = visions.jv, visions.tv
    jts = jv.init_train_state(jax.random.PRNGKey(3))
    h = np.random.default_rng(4).normal(0, 0.3, (N, 512)).astype(np.float32)
    jts = jts._replace(hidden=jnp.asarray(h), it=jnp.asarray(it, jnp.int32))
    ts = tv.init_train_state()
    ts.hidden, ts.it = torch.as_tensor(h), it
    jdata = update_inputs(jv)
    H, W = SMALL
    draws = tvis.VisionDraws(None, *update_draws(jts.key, VCFG["byol_minibatches"],
                                                 int(jdata["depth"].shape[0]) * N, H, W))
    jts2, jm = visions.update(jts, jdata)
    critic0 = {k: v.clone() for k, v in ts.actor.state_dict().items()
               if k.startswith(("critic", "scan_encoder", "priv_encoder", "std"))}
    tm = tv.update(ts, port_data(jdata), draws)

    assert set(tm) == set(jm) and ts.it == int(jts2.it) == it + 1
    # XLA fuses the jitted decay differently (eager JAX gives the port's
    # value): one float32 ulp apart at it = 15000
    np.testing.assert_allclose(float(tm["vision/lr"]), float(jm["vision/lr"]), rtol=1e-6)
    for k in jm:
        assert _rel(float(tm[k]), float(jm[k])) < 1e-5, (k, float(tm[k]), float(jm[k]))
    err = student_errors(ts, jts2)
    assert max(err.values()) < 1e-5, err
    for k, v in ts.actor.state_dict().items():
        if k in critic0:
            assert torch.equal(v, critic0[k]), k
    assert not torch.equal(ts.byol.backbone.fc0.weight, ts.byol_target.backbone.fc0.weight)


def test_vision_train_iteration_runs(visions):
    """train_iteration with the port's own draws on the smoke world: two
    chunks, the update and BYOL; every metric and parameter finite, the
    counter advanced, the GRU state the rollout's, the student moved from
    the teacher, the encoder and BYOL changed."""
    tv = visions.tv
    ts = tv.init_train_state()
    enc0 = ts.enc.backbone.fc0.weight.detach().clone()
    es = tv.env.init_state()
    ts, es, m = tv.train_iteration(ts, es)
    assert ts.it == 1 and all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(ts.enc.backbone.fc0.weight, enc0)
    assert float(torch.abs(ts.hidden).max()) > 0 and not ts.hidden.requires_grad
    moved = [not torch.equal(a, b) for a, b in zip(ts.actor.state_dict().values(),
                                                    tv.teacher_ac.state_dict().values())]
    assert any(moved)
    assert all(bool(torch.isfinite(p).all()) for mod in (ts.enc, ts.actor, ts.byol)
               for p in mod.parameters())


def test_student_policy_steps(visions):
    """StudentPolicy (play_tsc --use_camera): the encoder steps only at
    camera refreshes (every update_interval control steps) and its outputs
    are held between them; the state stays finite."""
    tv = visions.tv
    ts = tv.init_train_state()
    calls = []
    enc = ts.enc
    forward = enc.forward
    enc.forward = lambda *a: calls.append(1) or forward(*a)
    pol = tvis.StudentPolicy(tv, enc, ts.actor, torch.Generator().manual_seed(2))
    s = tv.env.init_state()
    for _ in range(7):
        s, _ = pol.step(tv.env, s)
    assert len(calls) == 2 and pol.t == 7
    assert bool(torch.isfinite(s.obs_buf).all())


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------


def test_vision_checkpoint_round_trip(visions, tmp_path):
    """Both directions: (1) a port VisionRunner's vision_<step>.msgpack is
    read by the JAX package's checkpoint.load_into into a template in the
    JAX command's layout ({enc_params, actor_params} from the flax modules'
    own init), every leaf equal, and its bytes are flax's own encoding of
    the same tree; (2) a JAX-written checkpoint of perturbed trees, BYOL's
    variables included, is carried into the port's modules by
    params_from_jax_vision and back by params_to_jax_vision, every leaf
    equal."""
    jv, tv, jts = visions.jv, visions.tv, visions.jts
    es = tv.env.init_state()
    r = tvis.VisionRunner(tv, es, log_dir=str(tmp_path))
    with torch.no_grad():
        for p in r.train_state.enc.parameters():
            p.add_(0.01)
    path = r.save(7)
    assert os.path.basename(path) == "vision_7.msgpack"
    template = {"enc_params": jv._enc_params0, "actor_params": jts.ac_params}
    restored = jckpt.load_into(path, jax.device_get(template))
    mine = r.checkpoint_tree()
    assert_trees_equal(restored, mine)
    assert_trees_equal(restored, jax.device_get(template), values=False)
    with open(path, "rb") as f:
        assert f.read() == ser.to_bytes(mine)

    tree = {"enc_params": _perturb(jv._enc_params0, 7), "actor_params": _perturb(jts.ac_params, 8),
            "byol_online": _perturb(jv._byol_state0.online, 9),
            "byol_target": _perturb(jv._byol_state0.online, 10)}
    jpath = jckpt.save(str(tmp_path / "jax" / "vision.msgpack"), jax.device_get(tree), step=3)
    sd = tckpt.params_from_jax_vision(tckpt.read_msgpack(jpath))
    ts = tv.init_train_state()
    for mod, k in ((ts.enc, "encoder"), (ts.actor, "actor_critic"), (ts.byol, "byol_online"),
                   (ts.byol_target, "byol_target")):
        mod.load_state_dict(sd[k])
    back = tckpt.params_to_jax_vision(ts.enc.state_dict(), ts.actor.state_dict(),
                                      ts.byol.state_dict(), ts.byol_target.state_dict())
    assert_trees_equal(back, jax.device_get(tree))


def assert_trees_equal(got, want, values=True):
    """The same leaf paths (and, with `values`, equal leaves, shapes and
    dtypes) in two nested dicts of arrays."""
    a = jax.tree_util.tree_flatten_with_path(got)[0]
    b = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, p
        if values:
            np.testing.assert_array_equal(x, y, err_msg=str(p))
