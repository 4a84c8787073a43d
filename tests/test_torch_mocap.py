"""The port's real-clip loading (envs/mocap.load_dir) and what reads the
loaded clips (the sampling paths, the env's reset, the trainer's expert
preload, train_bbc --mocap_dir) against agility_tpu on the same files.

The repository holds no mocap clips, so tests/torch_cases.write_clip_dir
writes a small set in the reference's layout from the synthetic gaits:
two clips of every mode at two frame durations (1/30 and 1/60 s) and
unequal lengths (72 and 90 frames), unequal motion weights, and two
unlabelled files of their own durations (1/40 and 1/50 s) — the per-clip
durations, lengths, weights and the separate unlabelled trajectory that
synthetic clips never exercise.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from agility_tpu.envs import config as jcfg
from agility_tpu.envs import go2_locomotion as jenv
from agility_tpu.envs import mocap as jmocap
from agility_tpu_torch.cli import train_bbc
from agility_tpu_torch.envs import config as tcfg
from agility_tpu_torch.envs import go2_locomotion as tenv
from agility_tpu_torch.envs import mocap as tmocap
from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
from agility_tpu_torch.learn import ssinfogail as tgail
from torch_cases import write_clip_dir

N = 4
DT = 0.02   # the env's control period
# float32 lerp and slerp on the same float32 tables, in another order of
# operations: measured up to 1.2e-7 on frames
SAMPLE_TOL = 1e-6
TABLES = ("frames", "clip_start", "clip_frames", "clip_dur", "clip_len", "weights", "label",
          "ulb_frames")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mocap"))
    return root, write_clip_dir(root)


def _dirs(root, ulb=True):
    return (os.path.join(root, "mocap_all_lb"),
            os.path.join(root, "mocap_all_ulb") if ulb else None)


@pytest.fixture(scope="module")
def motions(clip_root):
    """(JAX MotionData, the port's on the CPU) of the written clips."""
    root, _ = clip_root
    return (jmocap.load_dir(*_dirs(root), MOCAP_CATEGORIES),
            tmocap.load_dir(*_dirs(root), MOCAP_CATEGORIES, "cpu"))


@pytest.mark.parametrize("ulb", [True, False])
def test_load_dir_tables_bit_equal(clip_root, ulb):
    """Every MotionData field equals JAX's bit for bit, with the unlabelled
    set and without it (the labelled frames then serve, and ulb_dur is the
    first clip's)."""
    root, written = clip_root
    jm = jmocap.load_dir(*_dirs(root, ulb), MOCAP_CATEGORIES)
    tm = tmocap.load_dir(*_dirs(root, ulb), MOCAP_CATEGORIES, "cpu").host()
    for k in TABLES:
        a, b = getattr(tm, k), np.asarray(getattr(jm, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
    assert np.array_equal(tm.cat_logits, jm._cat_logits())
    assert tm.ulb_dur == jm.ulb_dur and tm.categories == jm.categories
    # the tables hold what the files hold
    assert tm.clip_frames.tolist() == [n for _, n in written["lb"]]
    want_ulb = sum(n for _, n in written["ulb"]) if ulb else tm.frames.shape[0]
    assert tm.ulb_frames.shape == (want_ulb, tmocap.FRAME_DIM)
    # the last unlabelled file's, or else the first labelled clip's (canter_0)
    assert tm.ulb_dur == (1 / 50.0 if ulb else 1 / 30.0)
    assert sorted(set(tm.clip_dur.tolist())) == sorted({np.float32(1 / 60.0).item(),
                                                        np.float32(1 / 30.0).item()})


def test_load_dir_rejects_a_file_without_category(tmp_path):
    """A labelled file whose name holds no category raises ValueError on
    both sides."""
    write_clip_dir(str(tmp_path), ulb=False)
    os.rename(tmp_path / "mocap_all_lb" / "trot_0.txt", tmp_path / "mocap_all_lb" / "gallop_0.txt")
    lb = str(tmp_path / "mocap_all_lb")
    with pytest.raises(ValueError, match="gallop_0.txt"):
        jmocap.load_dir(lb, None, MOCAP_CATEGORIES)
    with pytest.raises(ValueError, match="gallop_0.txt"):
        tmocap.load_dir(lb, None, MOCAP_CATEGORIES, "cpu")


def test_reorder_matches(rng):
    """PyBullet -> FK reorder on random float64 frames (negative quaternion
    w included): the same arithmetic, the same bits."""
    f = rng.normal(size=(40, tmocap.FRAME_DIM))
    np.testing.assert_array_equal(tmocap._reorder_pb_to_fk(f), jmocap._reorder_pb_to_fk(f))
    assert (tmocap._reorder_pb_to_fk(f)[:, 6] >= 0).all()


def test_frames_at_on_loaded_clips(motions, rng):
    """frames_at at injected clips and times over every clip: times across
    each clip's length and past its end (clamped to the last frame)."""
    jm, tm = motions
    K = len(jm.clip_start)
    clip = np.repeat(np.arange(K), 16).astype(np.int32)
    t = (rng.uniform(0.0, 1.1, clip.size) * jm.clip_len[clip]).astype(np.float32)
    want = np.asarray(jm._frames_at(jnp.asarray(clip), jnp.asarray(t)))
    got = tm.frames_at(torch.as_tensor(clip).long(), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, atol=SAMPLE_TOL, rtol=0)


def test_sample_frames_on_loaded_clips(motions):
    """sample_frames: the port's draws replayed from a copy of its
    generator, put through JAX's formula (agility_tpu/envs/mocap.py:103-115)
    at those draws.  Every draw stays in its env's mode."""
    jm, tm = motions
    c_idx = torch.arange(60) % len(MOCAP_CATEGORIES)
    gen = torch.Generator().manual_seed(3)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    got = tm.sample_frames(gen, c_idx, DT)
    clip = torch.multinomial(torch.softmax(tm.cat_logits[c_idx], -1), 1, generator=replay)[:, 0]
    u = torch.rand(60, generator=replay)
    jc = jnp.asarray(clip.numpy())
    lens, durs = jnp.asarray(jm.clip_len)[jc], jnp.asarray(jm.clip_dur)[jc]
    t = jnp.maximum(1e-7, (lens - (DT * 2 + durs)) * jnp.asarray(u.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm._frames_at(jc, t)), atol=SAMPLE_TOL,
                               rtol=0)
    assert torch.equal(tm.label[clip], c_idx)


@pytest.mark.parametrize("labeled", [True, False])
def test_transition_frames_on_loaded_clips(motions, labeled):
    """sample_transition_frames with JAX's draws injected (its key chain
    re-derived): labelled by motion weight over clips of two durations, and
    along the separate unlabelled trajectory."""
    jm, tm = motions
    n, L = 200, 2
    key = jax.random.PRNGKey(7)
    want, want_lab = jm.sample_transition_frames(key, n, DT, labeled, L)
    got, lab = tm.transition_frames(*_jax_draws(key, jm, n, labeled), DT, labeled, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SAMPLE_TOL, rtol=0)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))


def test_ulb_frames_at_on_loaded_clips(motions, rng):
    """_ulb_frames_at along the unlabelled trajectory (110 frames of its
    last file's 1/50 s), times before its start and past its end
    included."""
    jm, tm = motions
    length = (jm.ulb_frames.shape[0] - 1) * jm.ulb_dur
    t = rng.uniform(-0.1, 1.1, 300).astype(np.float32) * np.float32(length)
    np.testing.assert_allclose(tm._ulb_frames_at(torch.as_tensor(t)).numpy(),
                               np.asarray(jm._ulb_frames_at(jnp.asarray(t))), atol=SAMPLE_TOL,
                               rtol=0)


def _cfg(m, root, plane=False):
    """The test's env config from config module `m` (the JAX package's or
    the port's): rough terrain, or flat with `plane`, mocap from `root`."""
    terrain = dict(terrain=m.TerrainCfg(mesh_type="plane", measure_heights=False)) if plane else {}
    return m.Go2LocomotionCfg(
        env=m.EnvCfg(num_envs=N), mocap_dir=root,
        domain_rand=m.DomainRandCfg(push_robots=False, action_delay=False),
        noise=m.NoiseCfg(add_noise=False), **terrain)


def test_env_reset_from_loaded_clips(clip_root, rng):
    """Go2LocomotionEnv with cfg.mocap_dir on rough terrain loads the clips,
    and its masked reset turns the same sampled clips and times into the
    same states as JAX's (frames at the times, spawn lifted by the terrain
    under it, velocities rotated into the world).  Tolerance SAMPLE_TOL on
    the frames, which the reset moves through one rotation."""
    root, _ = clip_root
    je, te = jenv.Go2LocomotionEnv(_cfg(jcfg, root)), tenv.Go2LocomotionEnv(_cfg(tcfg, root),
                                                                             "cpu")
    for k in TABLES:
        assert np.array_equal(np.asarray(getattr(te.motion.host(), k)),
                              np.asarray(getattr(je.motion, k))), k
    clip = rng.integers(0, len(je.motion.clip_start), N).astype(np.int32)
    t = (rng.uniform(0.0, 1.0, N) * je.motion.clip_len[clip]).astype(np.float32)

    class JFixed(jmocap.MotionData):
        def sample_frames(self, key, c_idx, dt, disc_obs_len=2):
            return self._frames_at(jnp.asarray(clip), jnp.asarray(t))

    class TFixed(tmocap.MotionData):
        def sample_frames(self, gen, c_idx, dt, disc_obs_len=2, shard=None):
            return self.frames_at(torch.as_tensor(clip).long(), torch.as_tensor(t))

    je.motion, te.motion = JFixed(*je.motion), TFixed(*te.motion)
    ts = te.init_state()
    js = jenv.LocoState(
        **{k: jnp.asarray(getattr(ts, k).numpy()) for k in tenv.LocoState._fields
           if k not in ("sim", "global_counter")},
        sim=jenv.eng.EnvState(*(jnp.asarray(x.numpy()) for x in ts.sim)),
        global_counter=jnp.int32(0), key=jax.random.PRNGKey(0))
    mask = np.ones(N, bool)
    jr = jax.jit(je._reset_where)(js, jnp.asarray(mask), jax.random.PRNGKey(1))
    tr = te._reset_where(ts, torch.as_tensor(mask))
    for k in ("base_pos", "base_quat", "dof_pos", "u"):
        np.testing.assert_allclose(getattr(tr.sim, k).numpy(), np.asarray(getattr(jr.sim, k)),
                                   atol=SAMPLE_TOL, rtol=0, err_msg=k)


def _jax_draws(key, jm, n, labeled):
    """The clips and uniforms JAX's sample_transition_frames draws from `key`."""
    kc, kt = jax.random.split(key)
    if labeled:
        logits = jnp.log(jnp.asarray(jm.weights, jnp.float32))
        clip = jax.random.categorical(kc, jnp.broadcast_to(logits, (n, jm.num_clips)), axis=-1)
    else:
        clip = jnp.zeros((n,), jnp.int32)
    return (torch.as_tensor(np.array(clip)).long(),
            torch.as_tensor(np.array(jax.random.uniform(kt, (n,)))))


def test_expert_preload_from_loaded_clips(clip_root):
    """SSInfoGAIL's expert preload on loaded clips (a 4-env flat-ground env
    with cfg.mocap_dir): the draws of the JAX trainer's key chain
    (PRNGKey(seed) split in 4, the last for the labelled table, folded
    with 1 for the unlabelled one) injected into the port's env, against
    the JAX trainer's preload (agility_tpu/learn/ssinfogail.py:166-176:
    sample_transition_frames, then disc_obs_from_frames of each frame of
    the stack, concatenated) on the same clips.  Disc features go through
    quaternion rotations and scales up to 20: held at 2e-5, as
    tests/test_torch_train.py does on the synthetic clips; labels exact."""
    root, _ = clip_root
    P = 256
    je = jenv.Go2LocomotionEnv(_cfg(jcfg, root, plane=True))
    te = tenv.Go2LocomotionEnv(_cfg(tcfg, root, plane=True), "cpu")
    jm = je.motion
    k4 = jax.random.split(jax.random.PRNGKey(0), 4)[3]
    keys = {True: k4, False: jax.random.fold_in(k4, 1)}

    class Injected(tmocap.MotionData):
        def sample_transition_frames(self, gen, n, dt, labeled, disc_obs_len=2):
            return self.transition_frames(*_jax_draws(keys[labeled], jm, n, labeled), dt,
                                          labeled, disc_obs_len)

    te.motion = Injected(*te.motion)
    ta = tgail.SSInfoGAIL(te, tgail.AlgoCfg(num_preload_transitions=P), seed=0)
    osc, ddp = je.cfg.normalization.obs_scales, je.mc.default_dof_pos

    def preload(key, labeled):
        frames, labels = jm.sample_transition_frames(key, P, je.dt, labeled, 2)
        return jnp.concatenate([jmocap.disc_obs_from_frames(frames[i], ddp, osc)
                                for i in range(2)], axis=-1), labels

    for labeled, got in ((True, ta.expert_lb), (False, ta.expert_ulb)):
        want, labels = jax.jit(preload, static_argnums=1)(keys[labeled], labeled)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
        if labeled:
            np.testing.assert_array_equal(ta.expert_labels.numpy(), np.asarray(labels))


def test_train_bbc_mocap_dir_trains_on_loaded_clips(clip_root, tmp_path):
    """train_bbc --mocap_dir --device cpu: one iteration of 4 envs on the
    loaded clips (full AlgoCfg: 200k + 200k preload from them)."""
    root, written = clip_root
    r = train_bbc.run(train_bbc.get_args([
        "--device", "cpu", "--task", "go2_locomotion_smoke", "--num_envs", str(N),
        "--max_iterations", "1", "--mocap_dir", root, "--log_root", str(tmp_path)]))
    m = r.env.motion
    assert r.current_iteration == 1
    assert m.clip_frames.tolist() == [n for _, n in written["lb"]]
    assert m.ulb_frames.shape[0] == sum(n for _, n in written["ulb"])
    # the expert tables come from the loaded clips: every mode drawn, by weight
    counts = torch.bincount(r.alg.expert_labels, minlength=len(MOCAP_CATEGORIES)).float()
    want = torch.stack([m.weights[m.label == c].sum() for c in range(len(MOCAP_CATEGORIES))])
    torch.testing.assert_close(counts / counts.sum(), want, atol=0.01, rtol=0)
    ts = r.train_state
    assert all(bool(torch.isfinite(p).all()) for k in ("ac", "est", "disc")
               for p in getattr(ts, k).parameters())
    assert os.path.exists(os.path.join(str(tmp_path), "go2_locomotion_smoke", "0",
                                       "model_1.msgpack"))
