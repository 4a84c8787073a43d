"""The port runs where jax, flax and optax are not installed, and without
the JAX package: a fresh interpreter with jax, flax, optax and agility_tpu
blocked imports every module of agility_tpu_torch, chip_smoke.py, multi_card.py,
kernel_bench.py and window_dma_sweep.py (the layer tools of
agility_tpu_torch/tools/ among them), then takes two env steps of 2 envs on
the CPU and one on the per-env engine (sim.solver="pgs") and runs the
window A/B (tools/bench_windows) on a small world; a second one plays two hierarchical TSC steps of 2 envs on a
2-course world; a third trains the BBC for two iterations of 8 envs through
cli/train_bbc; a fourth trains the TSC teacher for two iterations of 4 envs
on 2 courses through cli/train_tsc (full TscAlgoCfg), then resumes from
the checkpoints it wrote for one more; a fifth trains the depth student for
one iteration of 4 envs on 2 courses through cli/train_tsc --use_camera
(full VisionCfg) and plays it for a few steps through cli/play_tsc
--use_camera from the checkpoint it wrote; a sixth plays the BBC through
cli/play_bbc --compare_gait; a seventh trains the BBC for one iteration
of 4 envs through cli/train_bbc --mocap_dir on clip files written in the
reference's layout; an eighth trains the BBC for one iteration of 8 envs
split over two gloo ranks that torch.distributed.run starts, through
cli/train_bbc --shard, with the modules blocked in every rank by a
sitecustomize on the ranks' path; a ninth runs the bench's main on the CPU
at 8 envs (the BBC line, one warm and one timed iteration)."""
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    # any import of them now fails
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    import agility_tpu_torch
    for m in pkgutil.walk_packages(agility_tpu_torch.__path__, "agility_tpu_torch."):
        importlib.import_module(m.name)
    import chip_smoke, kernel_bench, multi_card, window_dma_sweep
    from agility_tpu_torch.envs.config import Go2LocomotionCfg, EnvCfg
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.policy import build_policy
    cfg = Go2LocomotionCfg(env=EnvCfg(num_envs=2))
    env = Go2LocomotionEnv(cfg, "cpu")
    policy = build_policy(cfg, device="cpu")
    s = env.init_state()
    for _ in range(2):
        s, out = env.step(s, policy(s.obs_buf))
    assert s.obs_buf.shape == (2, 671) and bool(torch.isfinite(s.obs_buf).all())
    # the per-env engine (sim.solver="pgs": the world-frame Jacobi solve)
    from agility_tpu_torch.envs.config import SimCfg
    from agility_tpu_torch.physics.engine import uses_soa
    env = Go2LocomotionEnv(Go2LocomotionCfg(env=EnvCfg(num_envs=2), sim=SimCfg(solver="pgs")),
                           "cpu")
    assert not uses_soa(env.engine_cfg, env.grid)
    s = env.init_state()
    s, out = env.step(s, policy(s.obs_buf))
    assert bool(torch.isfinite(s.sim.u).all())
    # the window A/B (the window copies D and E on the CPU) on a small world
    from agility_tpu_torch.tools import bench_windows
    rows = bench_windows.bench("cpu", n=4, T=1, iters=1, H=100, W=100)
    assert len(rows) == 15 and all(r["ms"] > 0 for r in rows)
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")

TRAIN_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch.cli import train_bbc
    torch.set_num_threads(1)   # small ops: one thread is faster and spares the suite's cores
    with tempfile.TemporaryDirectory() as d:
        r = train_bbc.run(train_bbc.get_args([
            "--device", "cpu", "--task", "go2_locomotion_smoke", "--num_envs", "8",
            "--max_iterations", "2", "--log_root", d]))
        assert r.current_iteration == 2 and r.train_state.ring.size == 2 * 24 * 8
        assert all(bool(torch.isfinite(p).all()) for p in r.train_state.ac.parameters())
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


TSC_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch.cli import play_tsc
    res = play_tsc.run(play_tsc.get_args(["--device", "cpu", "--num_envs", "2",
                                          "--courses", "2", "--steps", "2"]))
    assert res["state"].obs_buf.shape == (2, 800)
    assert bool(torch.isfinite(res["state"].obs_buf).all())
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


TSC_TRAIN_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch.cli import train_tsc
    from agility_tpu_torch.io import checkpoint as ckpt
    torch.set_num_threads(1)   # small ops: one thread is faster and spares the suite's cores
    flags = ["--debug", "--device", "cpu", "--num_envs", "4", "--courses", "2"]
    with tempfile.TemporaryDirectory() as d:
        r = train_tsc.run(train_tsc.get_args(flags + ["--max_iterations", "2", "--log_root", d]))
        run_dir = os.path.join(d, "agility", "000")
        assert sorted(n for n in os.listdir(run_dir) if not n.startswith("events")) == [
            "model_2.msgpack", "state_2.pt"]
        tree = ckpt.read_msgpack(os.path.join(run_dir, "model_2.msgpack"))
        assert sorted(tree) == ["ac_params", "est_params", "iteration", "lr"]
        assert int(tree["iteration"]) == 2 and r.train_state.priv_reg_counter == 3
        std = r.train_state.ac.std.detach().clone()
        r2 = train_tsc.run(train_tsc.get_args(flags + [
            "--max_iterations", "1", "--log_root", d, "--resumeid", "000"]))
        assert r2.current_iteration == 3 and r2.train_state.priv_reg_counter == 4
        assert not torch.equal(r2.train_state.ac.std.detach(), std)
        assert os.path.exists(os.path.join(run_dir, "model_3.msgpack"))
        assert all(bool(torch.isfinite(p).all()) for p in r2.train_state.ac.parameters())
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


VISION_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch.cli import play_tsc, train_tsc
    from agility_tpu_torch.io import checkpoint as ckpt
    torch.set_num_threads(1)   # small ops: one thread is faster and spares the suite's cores
    with tempfile.TemporaryDirectory() as d:
        r = train_tsc.run(train_tsc.get_args([
            "--use_camera", "--debug", "--device", "cpu", "--num_envs", "4", "--courses", "2",
            "--max_iterations", "1", "--log_root", d, "--bbc_path",
            "logs/bbc_r5/bbc_final.msgpack"]))
        run_dir = os.path.join(d, "agility", "000")
        assert [n for n in os.listdir(run_dir) if not n.startswith("events")] == [
            "vision_1.msgpack"]
        assert r.train_state.it == 1 and r.current_iteration == 1
        assert all(bool(torch.isfinite(p).all()) for p in r.train_state.enc.parameters())
        res = play_tsc.run(play_tsc.get_args([
            "--device", "cpu", "--num_envs", "2", "--courses", "2", "--steps", "6",
            "--use_camera", "--vision_checkpoint", os.path.join(run_dir, "vision_1.msgpack")]))
        assert res["policy"].t == 6
        for a, b in zip(res["policy"].enc.state_dict().values(),
                        r.train_state.enc.state_dict().values()):
            assert torch.equal(a, b)
        assert bool(torch.isfinite(res["state"].obs_buf).all())
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


GAIT_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch.cli import play_bbc
    torch.set_num_threads(1)
    res = play_bbc.run(play_bbc.get_args([
        "--device", "cpu", "--num_envs", "2", "--steps", "5", "--mode", "trot",
        "--checkpoint", "logs/bbc_r5/bbc_final.msgpack", "--compare_gait"]))
    stats, bands, verdict = res["gait"]
    assert set(bands) == {"duty", "stride_hz", "diag_sync"} and set(verdict) == {*bands, "ok"}
    assert res["traj"]["contact"].shape == (5, 2, 4)
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


MOCAP_TRAIN_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    sys.path.insert(0, "tests")
    import torch
    from agility_tpu_torch.cli import train_bbc
    from torch_cases import write_clip_dir
    torch.set_num_threads(1)   # small ops: one thread is faster and spares the suite's cores
    with tempfile.TemporaryDirectory() as d:
        written = write_clip_dir(d)
        r = train_bbc.run(train_bbc.get_args([
            "--device", "cpu", "--task", "go2_locomotion_smoke", "--num_envs", "4",
            "--max_iterations", "1", "--mocap_dir", d, "--log_root", d]))
        assert r.current_iteration == 1
        assert r.env.motion.clip_frames.tolist() == [n for _, n in written["lb"]]
        assert all(bool(torch.isfinite(p).all()) for p in r.train_state.disc.parameters())
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


BENCH_SCRIPT = textwrap.dedent("""
    import json, os, sys
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
    import torch
    from agility_tpu_torch import bench
    torch.set_num_threads(1)   # small ops: one thread is faster and spares the suite's cores
    os.environ.update(BENCH_ENVS="8", BENCH_ITERS="1", BENCH_FAST="1", BENCH_TSC="0")
    bench.main(["--device", "cpu"])
    assert not any(k in ("jax", "agility_tpu") or k.startswith(("jax.", "flax", "optax",
                                                                  "agility_tpu."))
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


BLOCK_SITE = textwrap.dedent("""
    import sys
    sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None
    sys.modules["agility_tpu"] = None
""")


def _run(script):
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")]))}
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_imports_and_steps_without_jax():
    _run(SCRIPT)


def test_tsc_play_without_jax():
    _run(TSC_SCRIPT)


def test_bbc_train_without_jax():
    _run(TRAIN_SCRIPT)


def test_tsc_train_without_jax():
    _run(TSC_TRAIN_SCRIPT)


def test_vision_train_and_play_without_jax():
    _run(VISION_SCRIPT)


def test_bbc_play_compare_gait_without_jax():
    _run(GAIT_SCRIPT)


def test_bbc_train_mocap_dir_without_jax():
    _run(MOCAP_TRAIN_SCRIPT)


def test_bench_main_without_jax():
    """bench.main on the CPU at 8 envs (the BBC line, one timed iteration)."""
    res = subprocess.run([sys.executable, "-c", BENCH_SCRIPT], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             filter(None, [ROOT, os.environ.get("PYTHONPATH")]))},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = json.loads(res.stdout.splitlines()[0])
    assert line["metric"] == "env_steps_per_sec" and line["value"] > 0 and line["device"] == "cpu"
    assert res.stdout.strip().endswith("ok")


def test_bbc_train_shard_two_ranks_without_jax(tmp_path):
    """torch.distributed.run --nproc_per_node 2 of cli/train_bbc --shard on
    the CPU (gloo): rank 0 reports the split and writes the checkpoints."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCK_SITE)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(site), ROOT,
                                                       os.environ.get("PYTHONPATH")]))}
    logs = tmp_path / "logs"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "agility_tpu_torch.cli.train_bbc", "--device", "cpu", "--task",
         "go2_locomotion_smoke", "--num_envs", "8", "--max_iterations", "1", "--shard",
         "--log_root", str(logs)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "env-sharded over 2 rank(s), gloo; rank 0 holds envs [0, 4) of 8" in res.stdout
    assert res.stdout.count("trained 1 iters") == 1          # rank 0 alone prints
    run_dir = logs / "go2_locomotion_smoke" / "0"
    assert {"model_1.msgpack", "state_1.pt"} <= set(os.listdir(run_dir))
