"""The port's evaluation tooling against agility_tpu's on the same inputs:
the gait module and its bands (byte copies), play_bbc's gait verdicts and
exit codes, checkpoint resolution (ckpt.latest, play_bbc --log_root/
--experiment_idx, play_tsc --log_root/--proj_name/--exptid), interactive
play's key map and curses loop, the deployment export, the engine health
checks, the play logger and the make_gait_bands tool.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import agility_tpu
import agility_tpu_torch
from agility_tpu.cli import interactive as jinter
from agility_tpu.io import checkpoint as jckpt
from agility_tpu.io import export as jexport
from agility_tpu.io import gait as jgait
from agility_tpu.io import plotlog as jplotlog
from agility_tpu.physics import debug as jdebug
from agility_tpu.physics import engine as jeng
from agility_tpu_torch.cli import interactive as tinter
from agility_tpu_torch.cli import play_bbc, play_tsc
from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
from agility_tpu_torch.io import checkpoint as tckpt
from agility_tpu_torch.io import export as texport
from agility_tpu_torch.io import gait as tgait
from agility_tpu_torch.io import plotlog as tplotlog
from agility_tpu_torch.physics import debug as tdebug
from agility_tpu_torch.physics import engine as teng
from agility_tpu_torch.tools import make_gait_bands
from torch_cases import write_clip_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BBC_FINAL = os.path.join(ROOT, "logs", "bbc_r5", "bbc_final.msgpack")
TSC_TEACHER = os.path.join(ROOT, "logs", "agility", "r5", "model_12000.msgpack")
BANDS = os.path.join(os.path.dirname(agility_tpu_torch.__file__), "assets",
                     "gait_bands_real.json")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops here are small: one intra-op thread runs them
    faster than eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rel", [("io", "gait.py"), ("assets", "gait_bands_real.json")])
def test_gait_files_are_byte_identical(rel):
    """io/gait.py and the real-clip bands are byte copies of the JAX
    package's (the port imports nothing of it)."""
    with open(os.path.join(os.path.dirname(agility_tpu_torch.__file__), *rel), "rb") as f, \
            open(os.path.join(os.path.dirname(agility_tpu.__file__), *rel), "rb") as g:
        assert f.read() == g.read()


def _play_args(*extra, steps=30):
    return play_bbc.get_args(["--device", "cpu", "--num_envs", "4", "--steps", str(steps),
                              "--checkpoint", BBC_FINAL, "--mode", "trot", *extra])


@pytest.fixture(scope="module")
def played():
    """play_bbc --gait_bands on the real-clip bands: 4 envs, 30 steps, bbc_final."""
    return play_bbc.run(_play_args("--gait_bands", BANDS))


def test_play_bbc_gait_verdict_matches_jax(played):
    """The port's contact trace through the JAX gait functions and the
    port's: identical stats, verdict and report (30 steps: no transient
    is skipped); and the bands play_bbc derives from its env's clips (the
    host view of the MotionData) equal JAX bands_from_motion's on it."""
    contact = played["traj"]["contact"]
    assert contact.shape == (30, 4, 4) and contact.dtype == bool
    stats, bands, verdict = played["gait"]
    env = played["env"]
    jstats = jgait.gait_stats(contact, env.dt)
    assert stats.keys() == jstats.keys()
    for k in stats:
        np.testing.assert_array_equal(stats[k], jstats[k])
    assert verdict == jgait.compare(jstats, bands)
    assert tgait.format_report(stats, bands, verdict) == jgait.format_report(jstats, bands,
                                                                              verdict)
    host = env.motion.host()
    mode = MOCAP_CATEGORIES.index("trot")
    assert tgait.bands_from_motion(host, mode) == jgait.bands_from_motion(host, mode)


def test_play_bbc_gait_skips_the_transient():
    """Past 200 steps the first 100 are left out of the stats, as in JAX
    (a random 250-step trace of 3 envs against the real-clip bands)."""
    contact = np.random.default_rng(0).uniform(size=(250, 3, 4)) < 0.6
    stats, bands, verdict = play_bbc.compare_gait(_play_args("--gait_bands", BANDS),
                                                  types.SimpleNamespace(dt=0.02), contact)
    want = jgait.gait_stats(contact[100:], 0.02)
    for k in want:
        np.testing.assert_array_equal(stats[k], want[k])
    assert verdict == jgait.compare(want, bands)


@pytest.mark.parametrize("case,code", [("fail", 1), ("no_clips", 2), ("pass", None)])
def test_play_bbc_gait_exit_codes(tmp_path, case, code):
    """main exits 1 when the gait fails its bands, 2 when the mode has no
    clips, and returns when it passes (3 steps of 4 envs)."""
    bands = {"fail": {"clips": 2, "duty": [2.0, 3.0]}, "no_clips": {"clips": 0},
             "pass": {"clips": 2, "duty": [-1.0, 2.0], "diag_sync": [-1.0, 2.0]}}[case]
    path = tmp_path / "bands.json"
    path.write_text(json.dumps({"trot": bands}))
    argv = ["--device", "cpu", "--num_envs", "4", "--steps", "3", "--checkpoint", BBC_FINAL,
            "--mode", "trot", "--gait_bands", str(path)]
    if code is None:
        play_bbc.main(argv)
    else:
        with pytest.raises(SystemExit) as e:
            play_bbc.main(argv)
        assert e.value.code == code


def test_latest_resolves_like_jax(tmp_path):
    """ckpt.latest picks the same file as JAX's over model_<n> files among
    others, for each prefix, and None for a missing directory."""
    for name in ("model.msgpack", "model_5.msgpack", "model_40.msgpack", "model_7.msgpack",
                 "state_40.pt", "model_x.msgpack", "vision_3.msgpack", "vision_12.msgpack",
                 "model_100.msgpack.tmp"):
        (tmp_path / name).write_bytes(b"")
    for prefix in ("model", "vision", "state"):
        assert tckpt.latest(str(tmp_path), prefix) == jckpt.latest(str(tmp_path), prefix)
    assert tckpt.latest(str(tmp_path)).endswith("model_40.msgpack")
    assert tckpt.latest(str(tmp_path / "nope")) is None is jckpt.latest(str(tmp_path / "nope"))


def test_play_bbc_resolves_the_run_directory(tmp_path):
    """play_bbc --log_root/--experiment_idx loads the newest model_<n> of
    <log_root>/<task>/<idx> (model_9, linked to bbc_15k, over model_2,
    linked to bbc_final), the weights --checkpoint loads from that file;
    --checkpoint wins over the run directory."""
    run = tmp_path / "go2_locomotion" / "3"
    run.mkdir(parents=True)
    bbc_15k = os.path.join(ROOT, "logs", "bbc_r5", "bbc_15k.msgpack")
    os.symlink(bbc_15k, run / "model_9.msgpack")
    os.symlink(BBC_FINAL, run / "model_2.msgpack")
    base = ["--device", "cpu", "--num_envs", "2", "--log_root", str(tmp_path)]
    weights = lambda *extra: list(play_bbc.build(play_bbc.get_args(base + list(extra)))[1]
                                  .state_dict().values())
    for got, want in ((weights("--experiment_idx", "3"), weights("--checkpoint", bbc_15k)),
                      (weights("--experiment_idx", "3", "--checkpoint", BBC_FINAL),
                       weights("--checkpoint", BBC_FINAL))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not all(torch.equal(a, b) for a, b in zip(weights("--checkpoint", bbc_15k),
                                                     weights("--checkpoint", BBC_FINAL)))


def test_play_tsc_resolves_the_run_directory(tmp_path):
    """play_tsc --log_root/--proj_name/--exptid loads the same teacher
    weights as --checkpoint (2 envs on 2 courses)."""
    run = tmp_path / "agility" / "r5"
    run.mkdir(parents=True)
    os.symlink(TSC_TEACHER, run / "model_12000.msgpack")
    base = ["--device", "cpu", "--num_envs", "2", "--courses", "2"]
    _, by_name, _ = play_tsc.build(play_tsc.get_args(
        base + ["--log_root", str(tmp_path), "--proj_name", "agility", "--exptid", "r5"]))
    _, by_file, _ = play_tsc.build(play_tsc.get_args(base + ["--checkpoint", TSC_TEACHER]))
    assert play_tsc.run_dir(play_tsc.get_args(base)) == os.path.join("logs", "agility", "000")
    sd_name, sd_file = by_name.state_dict(), by_file.state_dict()
    assert sd_name.keys() == sd_file.keys()
    for k in sd_name:
        if k.startswith(("ac.", "est.")):
            assert torch.equal(sd_name[k], sd_file[k]), k


@pytest.mark.parametrize("start", [
    dict(vx=0.0, vy=0.0, wz=0.0, jump_h=0.3, loco_h=0.30),
    dict(vx=1.0, vy=-0.3, wz=0.2, jump_h=0.1, loco_h=0.20),
    dict(vx=-0.5, vy=0.4, wz=-1.0, jump_h=0.8, loco_h=0.45)])
def test_apply_key_matches_jax(start):
    """Every key code 0-255 in every mode, from three command states (at
    the height ranges' ends too): the same command, mode and action."""
    jh, lh = (0.1, 0.8), (0.2, 0.45)
    for mode in range(len(jinter.MODES)):
        for ch in range(256):
            assert tinter.apply_key(ch, start, mode, jh, lh) == jinter.apply_key(
                ch, start, mode, jh, lh), (ch, mode)


class _FakeScreen:
    """A curses window stand-in: getch returns the queued keys, then -1
    (no key) until the queue ends in a quit."""
    def __init__(self, keys):
        self.keys = list(keys)
        self.lines = {}

    def nodelay(self, flag):
        pass

    def getch(self):
        return self.keys.pop(0) if self.keys else ord("x")

    def erase(self):
        self.lines = {}

    def addstr(self, y, x, text):
        self.lines[y] = text

    def refresh(self):
        pass


def test_interactive_loop_steps_under_keys():
    """The curses loop on a stand-in window (2 envs): w w 3 raise vx to
    0.2 in trot, r reseeds the env's generator and resets, x quits; the
    panel shows the mode and command, and the state holds them."""
    env, policy, _, _ = play_bbc.build(play_bbc.get_args(
        ["--device", "cpu", "--num_envs", "2", "--checkpoint", BBC_FINAL, "--interactive"]))
    assert env.num_mocap == len(MOCAP_CATEGORIES)          # every mode switchable
    scr = _FakeScreen([ord("w"), ord("w"), ord("3"), -1, ord("r"), -1])
    state = tinter.loop(scr, env, policy, env.init_state(), mode_idx=0)
    assert "mode [3] trot" in scr.lines[2] and "vx +0.20" in scr.lines[2]
    assert "step 6" in scr.lines[6]
    torch.testing.assert_close(state.commands[:, 0], torch.full((2,), 0.2))
    assert state.latent_c.argmax(-1).tolist() == [2, 2]
    assert bool(torch.isfinite(state.obs_buf).all())


def _bbc_policy(n=8):
    from agility_tpu_torch.envs.config import EnvCfg, Go2LocomotionCfg
    from agility_tpu_torch.learn.policy import build_policy

    sd = tckpt.params_from_jax(tckpt.read_msgpack(BBC_FINAL))
    return build_policy(Go2LocomotionCfg(env=EnvCfg(num_envs=n)), sd, "cpu"), sd


def test_export_params_npz_matches_jax(tmp_path):
    """export_params_npz of the flax tree params_to_jax builds from
    bbc_final: the same keys, in the same order, and the same arrays as the
    JAX package's export_params_npz of that tree."""
    policy, sd = _bbc_policy()
    tree = tckpt.params_to_jax(policy.ac.state_dict(), policy.est.state_dict(),
                               sd["discriminator"])
    mine = np.load(texport.export_params_npz(tree, str(tmp_path / "port")))
    theirs = np.load(jexport.export_params_npz(tree, str(tmp_path / "jax")))
    assert mine.files == theirs.files and len(mine.files) == 45
    for k in theirs.files:
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_export_policy_round_trip(tmp_path):
    """torch.export of the BBC inference policy at 8 observations, saved
    and loaded back: the loaded program's actions match the eager policy's
    within 1e-6 (measured: equal)."""
    policy, _ = _bbc_policy()
    obs = torch.randn(8, 671, generator=torch.Generator().manual_seed(0))
    path = texport.export_policy(policy, (obs,), str(tmp_path / "bbc"))
    assert path.endswith(".pt2") and os.path.exists(path)
    loaded = texport.load_policy(path)
    obs2 = torch.randn(8, 671, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(loaded(obs2), policy(obs2), atol=1e-6, rtol=0)


def _sick_states():
    """The same 4 states for both packages: env 1 holds a NaN, env 2 moves
    at 40 m/s."""
    rng = np.random.default_rng(0)
    arrs = dict(base_pos=rng.normal(0, 0.1, (4, 3)) + [0, 0, 0.35],
                base_quat=np.tile([0.0, 0.0, 0.0, 1.0], (4, 1)),
                dof_pos=rng.normal(0, 0.3, (4, 12)), u=rng.normal(0, 0.5, (4, 18)))
    arrs["base_pos"][1, 2] = np.nan
    arrs["u"][2, 0] = 40.0
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return (teng.EnvState(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
            jeng.EnvState(**{k: jnp.asarray(v) for k, v in arrs.items()}))


def test_state_health_and_speed_gate_match_jax():
    """state_health and speed_gate: the same keys and values within 1e-6
    as JAX's on states with a NaN env and an overspeed env."""
    ts, js = _sick_states()
    for tf, jf in ((tdebug.state_health, jdebug.state_health),
                   (tdebug.speed_gate, jdebug.speed_gate)):
        got, want = tf(ts), jf(js)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), atol=1e-6, rtol=0,
                                       err_msg=k)
    assert int(tdebug.state_health(ts)["nonfinite_envs"]) == 1
    assert float(tdebug.speed_gate(ts)["overspeed_frac"]) == 0.25
    assert tdebug.GO2_SPEED_GATE == jdebug.GO2_SPEED_GATE


def test_checked_and_assert_finite_raise():
    """checked(fn) raises naming the first non-finite output's path and
    passes finite outputs through; assert_finite raises naming its tag."""
    ts, _ = _sick_states()
    with pytest.raises(FloatingPointError, match=r"\[1\]\.base_pos"):
        tdebug.checked(lambda s: (s.u.sum(), s))(ts)
    fine = ts._replace(base_pos=torch.nan_to_num(ts.base_pos))
    out = tdebug.checked(lambda s: {"sim": s, "n": 3})(fine)
    assert out["sim"] is fine
    with pytest.raises(FloatingPointError, match=r"solver\[1\]"):
        tdebug.assert_finite("solver", fine.u, ts.base_pos)
    tdebug.assert_finite("solver", fine.u)


def _log_both(steps=5):
    rng = np.random.default_rng(0)
    tl, jl = tplotlog.Logger(0.02), jplotlog.Logger(0.02)
    for i in range(steps):
        d = {"base_vel_x": rng.normal(), "command_x": 1.0, "dof_torque": rng.normal(size=3),
             "contact_forces_z": rng.uniform(0, 50, 4)}
        jl.log_states(d)
        tl.log_states({k: torch.as_tensor(v) if k == "dof_torque" else v for k, v in d.items()})
        r = {"tracking": rng.uniform(size=4), "torque": -rng.uniform(size=4)}
        jl.log_rewards(r, num_episodes=2)
        tl.log_rewards({"tracking": torch.as_tensor(r["tracking"]), "torque": r["torque"]}, 2)
    return tl, jl


def test_logger_matches_jax():
    """Logger accumulation (tensors copied to the host) and print_rewards
    output equal the JAX Logger's on the same values."""
    tl, jl = _log_both()
    assert tl.state_log.keys() == jl.state_log.keys() and tl.num_episodes == jl.num_episodes
    for k in jl.state_log:
        np.testing.assert_array_equal(np.stack(tl.state_log[k]), np.stack(jl.state_log[k]))
    assert tl.rew_log == jl.rew_log
    outs = []
    for logger in (tl, jl):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            logger.print_rewards()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "tracking" in outs[0]
    tl.reset()
    assert not tl.state_log and tl.num_episodes == 0


def test_logger_plot_states_writes_a_file(tmp_path):
    """plot_states under Agg writes the six-panel figure."""
    pytest.importorskip("matplotlib")
    tl, _ = _log_both()
    path = tmp_path / "states.png"
    tl.plot_states(str(path))
    assert path.stat().st_size > 1000


def test_make_gait_bands_is_byte_identical_to_jax(tmp_path):
    """The port's tool (on the CPU) and the JAX tool (its own process,
    JAX_PLATFORMS=cpu) write the same bytes from the same clips; --out is a
    temporary path for both."""
    root = str(tmp_path / "clips")
    write_clip_dir(root, ulb=False)
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    make_gait_bands.main(["--mocap_dir", root, "--out", str(mine), "--device", "cpu"])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_gait_bands.py"),
                          "--mocap_dir", root, "--out", str(theirs)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert mine.read_bytes() == theirs.read_bytes()
    assert b'"clips": 2' in mine.read_bytes()


def test_diagnose_tools_run(capsys):
    """diagnose_gait (bbc_final, 2 envs, 6 steps) and diagnose_tsc (the r5
    teacher resolved from logs/agility/r5, 2 envs on 2 courses, 6 steps)
    run on the CPU and print the JAX tools' report lines."""
    from agility_tpu_torch.tools import diagnose_gait, diagnose_tsc

    traj = diagnose_gait.main(["--device", "cpu", "--checkpoint", BBC_FINAL, "--num_envs", "2",
                               "--steps", "6"])
    assert traj["speed"].shape == (6, 2) and np.isfinite(traj["speed"]).all()
    out = diagnose_tsc.main(["--device", "cpu", "--bbc_path", BBC_FINAL, "--log_root",
                             os.path.join(ROOT, "logs"), "--num_envs", "2", "--courses", "2",
                             "--steps", "6"])
    assert out["mode_counts"].sum() == 12
    text = capsys.readouterr().out
    for line in ("resets/env over rollout", "peak speed", "teacher: ", "end causes",
                 "dist to current goal"):
        assert line in text, line
    assert os.path.join("agility", "r5", "model_12000.msgpack") in text
