"""The port's CUDA kernels on the card, against their plain-torch versions.

Runs only where torch sees a CUDA card; elsewhere each test skips.  Imports
no jax, so on the card machine (no jax installed) run it without the suite's
conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import pytest
import torch

from agility_tpu_torch.kernels import contact_lcp as k1
from agility_tpu_torch.kernels import scandots as k3
from agility_tpu_torch.kernels import terrain_window as k2
from agility_tpu_torch.physics import engine as teng
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
        assert out["vs_baseline"] == round(24 * 64 / dt / bench.BASELINES[metric], 3)
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
    assert row["finite"] and row["launches"] == dict(contact_lcp=4, terrain_window=1, scandots=0)
    assert bench_env_ablate.device_ops(env, begin, **patches) > 1000
