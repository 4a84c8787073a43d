"""Smoke run of the PyTorch port on one CUDA card: builds the kernels from the
repository's sources, checks each against its plain-torch version at the main
paths' shapes (the 32k tasks' included), then drives the port's serving
paths at full width — the BBC policy rollout with its gait verdict
(agility_tpu_torch.cli.play_bbc --gait_bands), the TSC obstacle-course
evaluation (agility_tpu_torch.cli.play_tsc, its teacher resolved by run
name) and the depth student's (play_tsc --use_camera) — its training paths
(cli/train_bbc, on the synthetic clips and on clip files through
--mocap_dir, cli/train_tsc and train_tsc --use_camera), the policy export,
env-axis data parallelism (two ranks on the card against one process),
the 32k tasks through --shard, the bench (agility_tpu_torch/bench.py) and
the env-layer ablation tools, and checks what comes out.

    python3 chip_smoke.py            # needs one CUDA card; exits nonzero without one

Phases (any failure exits nonzero and prints no result line):
  1. build   — nvcc builds csrc/{contact_lcp,terrain_window,scandots}.cu for
               sm_90a, one process per source, all at once (timed).
  2. K1      — the contact LCP kernel against contact_lcp_reference on one card,
               inputs built by the port's own SoA code from a real batch of
               states, at every path's shape: the BBC's (N = 4096, S = 24), the
               TSC's (N = 6144 on 64 courses, S = 28, 64 envs pressed into the
               tunnel roof so that ceiling rows are active) and the depth
               student's (N = 256 on 64 courses, S = 28, 64 envs in the roof:
               one env a persistent block, so the ring streams no second env).  5 sweeps
               warm-started from a nonzero lam0, and 10 sweeps cold.  Tolerance:
               max |kernel - plain| <= 1e-4 x max |plain| (float32, sums in
               another order); two calls on the same inputs give the same bits.
               Each kernel is timed with the L2 warm across calls (the
               wrapper's host time included where the card waits for it) and
               with the L2 flushed (a 256 MB write before each call, the card
               kept busy while the host enqueues: the kernel's own time); its
               bound is
               the larger of its bytes (each input read once, each output
               written once) over 3.35 TB/s and its flops over 67 TFLOP/s,
               and its share of the bound is taken from the flushed time.
  3. K2      — the terrain window against patch.extract_batch, exactly equal
               (floor, ceiling, origins), at both paths' shapes: the default
               64-course world (1320 x 1800, five surfaces), N = 6144 windows of
               32 cells centred on goal waypoints, weights over the bar, tire and
               tilt ranges, with the counts of layer, lever and ceiling cells
               under the windows > 0, and the same at the depth student's N = 256;
               and the BBC's rough grid (one surface, no weights), N = 4096 windows at the spawn points and, for every
               other env, anywhere on or off the map, so that origins clamp at
               the edges; the same on the bench's BBC grid (bench.bbc_config:
               the 4 x 4 terrain with a 10 m border, 600 x 600 cells).  Two
               calls give the same bits.  The bytes count each distinct grid
               cell under the windows once; beside them, the distinct
               32-byte sectors those cells touch, per surface.  The
               launch parameters and each surface's route (staged by TMA or
               cp.async, or plain loads) are printed.
  4. K3      — the scandots against patch.measure_scandots_batch on that world,
               N = 6144 scans of 132 points and the depth student's N = 256,
               window 34: exactly equal, two calls the same bits.  The bytes count each distinct grid node the scans
               read once; sectors, launch parameters and routes (a gather)
               as for K2.
  4a. bench — agility_tpu_torch/bench.py's bench_bbc (4096 envs on its
               600 x 600 config) and bench_tsc (6144 envs on 64 courses), each
               one warm and one timed iteration with the fast preload: each
               line has the root bench's keys, finite values > 0, and its
               value and vs_baseline are the root bench's rounding of the
               measured rate; launches K1 4 and K2 1 a control step (the
               env's init_state step included), K3 1 a step on the TSC line
               and 0 on the BBC's.
  5. parity  — one BBC control step of a 64-env batch on the card against the
               same step on the CPU (plain versions), from one state.
  6. TSC parity — one TSC env step of 64 envs (8 courses) on the card against the
               CPU, from one state with 8 envs pressed against the tunnel roof
               (active ceiling contacts, printed); envs that the step resets are
               compared on their pre-reset (terminal) features, within 1e-3.
  7. BBC slice — play_bbc at 4096 envs on the rough-terrain Go2LocomotionCfg with
               logs/bbc_r5/bbc_15k.msgpack for 60 control steps (trot, vx 1.0)
               and --gait_bands on the port's assets/gait_bands_real.json; K1
               launches = substeps run, K2 launches = control steps + 1, every
               state finite, median base height over the terrain in [0.15,
               0.45] m; the gait report (duty, stride_hz, diag_sync over the
               run, against the real-clip trot bands) printed with
               the JAX package's trot line of logs/bbc_r5/gait_report_28k.txt
               beside it (another checkpoint, 8 envs, 300 steps on a CPU: not
               a comparable number).  Gated only on the stats being finite
               and physical (duty and sync in [0, 1], stride_hz in [0, 1/(2
               dt)]): the verdict is a reading, not a gate.
               The slice also profiles two control steps (device ops, busy
               share) for the per-env slices to print beside theirs.
  7a. K1 per-env — K1 on the per-env engine's route
               (kernels/contact_lcp.per_env_problem: G = JpT^T M^-1 JpT and the
               other inputs from engine._pre_contact, one substep into the BBC
               batch of phase 2, N = 4096, S = 24, 10 cold sweeps), gated and
               timed as phase 2.
  7b. per-env parity — one env step of 64 envs on the card against the CPU
               for every per-env engine variant: solver jacobi (soa=False) and
               pgs on the fast path (K1), pgs and jacobi with fast=False, soft
               with fast on and off, patch_size=0, pallas_contact; then a TSC
               env step (64 envs, 8 courses, 8 pressed into the tunnel roof)
               with solver pgs, which the fast path's window keeps on the
               per-env path with active ceiling rows (the JAX package's rule),
               and with fast=False, which the ceiling forces onto SoA.  Each at
               tests/test_soa.py's tolerances, with the launches it must make.
  7c. BBC per-env slice — play_bbc's build and rollout (sim.solver set through
               its `overrides` keyword) at 4096 envs, bbc_15k, trot at vx 1.0,
               50 control steps, twice: solver pgs (the per-env Jacobi solve
               through K1) and soft.  K1 launches = substeps (pgs) or 0 (soft),
               K2 = steps + 1, finite states, median base height over the
               terrain in [0.15, 0.45] m; env-steps/s, device ops per control
               step and busy share (two steps profiled) beside the SoA slice's.
  7d. PGS contact frames — EngineConfig(solver="pgs", fast=False), the serial
               Gauss-Seidel solve (plain torch), on play_bbc's env and policy at
               4096 envs for 10 control steps: timed, one step profiled, no K1
               or K2 launch, finite, base height in range.
  8. TSC slice — play_tsc at 6144 envs on 64 courses with the TSC teacher
               resolved through --log_root/--proj_name/--exptid (a temporary
               root whose agility/r5 links logs/agility/r5/model_12000.msgpack;
               the weights loaded must equal that file's) and the frozen BBC
               logs/bbc_r5/bbc_final.msgpack for 20 control steps; K1 launches =
               4 x (steps + 1), K2 = K3 = steps + 1, every state finite, median
               base height over the folded floor in [0.15, 0.45] m.
  9. train parity — one BBC train iteration of 64 envs (T = 8, the rough
               go2_locomotion config with observation noise and pushes off,
               the full AlgoCfg otherwise) on the card against the CPU, from
               one start state, the same weights and expert tables and the
               same draws: the rollout's end states against the SoA
               tolerances (envs reset on either side excluded; both must
               reset the same envs); then GAE, PPO, the disc update and DAgger
               on identical inputs (the CPU rollout's transitions and ring
               fed to both): each stage's metrics within TRAIN_TOL relative
               and the parameters of the networks it updates within TRAIN_TOL
               (the disc update's within DISC_PARAM_TOL), as |card - CPU| /
               |CPU| over each network.
 10. BBC train — cli/train_bbc at 4096 envs on go2_locomotion with the full
               AlgoCfg for 1 iteration (it runs DAgger): its time and its
               stages' times (CUDA events), env-steps/s over it, peak device
               memory, the metrics; K1 launches = 4 x 24, K2 = 24 (counted
               after the runner's init), every parameter and metric finite,
               ring size 24 x 4096, normaliser count above its start, and the slim checkpoint
               read back by play_bbc's policy loader to equal tensors; the env
               step alone (zero actions) timed before and after training; then
               one more iteration under torch.profiler for the device's busy
               share.
 11. BBC mocap — a clip set written in the reference's layout
               (tests/torch_cases.write_clip_dir: two clips of each mode at 1/30
               and 1/60 s a frame, 72 and 90 frames, unequal motion weights,
               and two unlabelled files) into a temporary <dir>/mocap_all_lb and
               mocap_all_ulb; envs/mocap.load_dir onto the card bit-equal to
               load_dir on the CPU; then cli/train_bbc --mocap_dir <dir> at 4096
               envs on go2_locomotion with the full AlgoCfg for 1 iteration: K1
               launches = 4 x 24, K2 = 24, every parameter and metric finite,
               the motion tables' clip and frame counts those of the files, every
               mode among the expert labels, the checkpoint read back to equal
               tensors; prints the build, iteration and preload times.
 12. export — io/export.export_policy (torch.export) of the BBC inference
               policy with logs/bbc_r5/bbc_final.msgpack at 4096 observations
               on the card, then load_policy: the loaded program's actions
               within 1e-6 absolute of the eager policy's on the same obs;
               export_params_npz of params_to_jax's flax tree: the same keys
               (jax.tree_util.keystr paths, sorted) and arrays, key for key.
 13. TSC train parity — one TSC teacher train iteration of 64 envs on 8
               courses (T = 8, the go2 config with randomize_start and the
               base mass and CoM randomised, command noise off: its draws come
               from the env's generator, which differs on the card) on the
               card against the CPU, from one start state, the same weights,
               the frozen bbc_final and the same draws: the rollout's end
               states against the SoA tolerances, its modes equal and its
               stored rewards, values, both log-probs and means within
               ROLLOUT_TOL (envs reset on either side excluded; both must
               reset the same envs); then GAE, PPO and DAgger on identical
               inputs within TRAIN_TOL, the learning rate equal.
 14. TSC train — cli/train_tsc at 6144 envs on 64 courses with the frozen
               logs/bbc_r5/bbc_final.msgpack, the reference's teacher flags
               (--randomize_start --randomize_base_mass --randomize_base_com
               --push_robots) and the full TscAlgoCfg for 1 iteration (it
               runs DAgger): timed as BBC train; K1 launches = 4 x 24, K2 = K3
               = 24, every parameter and metric finite, priv_reg_counter 2,
               std >= min_std, the slim checkpoint read back by
               params_from_jax_tsc to equal tensors; then one more iteration
               under torch.profiler.
 15. vision parity — one depth-student iteration of 64 envs on 8 courses
               (T = 8: camera chunks of 5 and 3, the teacher model_12000 and
               the frozen bbc_final, command noise off) on the card against
               the CPU, from one state, the same student weights and draws:
               the refresh images by the crossing rule (raycast.crossing_mask), the
               rollout's states, stored obs and teacher targets; then on
               identical inputs the encoder's outputs, the four losses and
               every parameter after the update (phase_vision_parity states
               the tolerances).
 16. vision train — cli/train_tsc --use_camera at camera_num_envs = 256
               envs on 64 courses, the full VisionCfg (T = 24, six BYOL
               minibatches) and the 87 x 58 camera with 32 march samples,
               the teacher logs/agility/r5/model_12000.msgpack resolved
               through a temporary --log_root that links it, for 1
               iteration: timed as BBC train, with each stage (the
               estimator before a refresh, the ray-march, depth processing,
               encoder, heads and commands, env step, update, BYOL) and the ray-march's ms a refresh and share
               of an iteration; K1 launches = 4 x 24, K2 = K3 = 24, every
               parameter and metric finite, vision_1.msgpack read back
               by params_from_jax_vision to equal tensors; then one more
               iteration under torch.profiler.
 17. vision play — cli/play_tsc --use_camera at 256 envs on 64 courses
               with that checkpoint, the teacher's estimator and the frozen
               BBC for 10 control steps: K1 launches = 4 x (steps + 1), K2 =
               K3 = steps + 1, every state finite, median base height over
               the folded floor in [0.15, 0.45] m, env-steps/s; then two
               steps under torch.profiler.
 18. DDP parity — dist/mesh.py with two gloo ranks on the one card
               (mesh.launch; NCCL refuses two ranks on one device) against
               one process on the card: a BBC env step and two TSC env steps
               (64 envs; 64 x 8 courses, a quarter finishing their course,
               the curriculum due), one BBC and one TSC teacher iteration (T
               = 8, train parity's configs), and the update stages on the
               one-process rollout at two trainer sizes; gated at
               tests/test_dist.py's tolerances (phase_ddp_parity states
               them), the ranks' parameters bit-identical, K1-K3 launched
               in each rank.
 19. BBC train 32k — cli/train_bbc --task go2_locomotion_32k --shard in a
               one-rank NCCL group: 32768 envs on the 8 x 8 terrain, the full
               AlgoCfg, 1 iteration (DAgger, the saves): timed as BBC train
               (env-steps/s of that iteration), the collectives counted and
               timed, the env step's busy share (two steps profiled), peak
               memory, launches K1 96 / K2 24, ring 786,432 of 983,040 rows,
               both checkpoints read back equal; then K1 (warm and cold) and
               K2 against their plain versions at N = 32768.
 20. TSC train 32k — cli/train_tsc --task go2_32k --shard: 32768 envs on
               256 courses, the teacher flags, the frozen bbc_final, 1
               iteration; as BBC train 32k, with the world's generation
               timed, launches K1 96 / K2 24 / K3 24, priv_reg_counter 2;
               then K1 (64 envs pressed into the roof), K2 and K3 at N =
               32768 on the 256-course world.
 21. env ablation — tools/bench_env_ablate and bench_env_ablate_tsc at the
               bench's widths, T = 2 steps, one rep (last: their device-op
               counts run torch.profiler, which slows the host's later
               launches): every variant's rewards finite; in each full step
               K1 4 and K2 1 a step, K3 1 a step on the TSC and 0 on the BBC;
               K3 0 under "no _measure_heights" and "no
               _compute_observations" (the stub took effect).
Each phase prints its own seconds when it ends, and a line before the
total gives them all as JSON.  The line before the kernels' JSON record
gives the script's total wall time; the line before the last is the
kernels' JSON record; the last line is the device record.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "logs", "bbc_r5", "bbc_15k.msgpack")
TSC_CHECKPOINT = os.path.join(ROOT, "logs", "agility", "r5", "model_12000.msgpack")
TSC_BBC = os.path.join(ROOT, "logs", "bbc_r5", "bbc_final.msgpack")
GAIT_BANDS = os.path.join(ROOT, "agility_tpu_torch", "assets", "gait_bands_real.json")
JAX_GAIT_REPORT = os.path.join(ROOT, "logs", "bbc_r5", "gait_report_28k.txt")
KERNELS = ("contact_lcp", "terrain_window", "scandots")   # csrc/<name>.cu
K1_RTOL = 1e-4
NUM_ENVS = 4096     # the BBC path's width
STEPS = 60          # control steps of the BBC slice phase (cut from 250, then 120, for time)
TSC_ENVS = 6144     # the TSC config's width (TscEnvCfg.num_envs), on 64 courses
TSC_STEPS = 20      # control steps of the TSC slice phase (cut from 200, 100, then 40, for time)
TRAIN_ITERS = 1     # iterations of the BBC, TSC and vision train phases (cut from 3 for
#                     the 32k phases' time, then from 2 for the per-env phases')
BIG_ENVS = 32768    # the 32k tasks' width (go2_locomotion_32k, go2_32k), one iteration each
DDP_ENVS = 64       # DDP parity: 2 gloo ranks on one card against one process
PER_ENV_STEPS = 50   # control steps of each BBC per-env slice (pgs, soft; cut from 100 for time)
PGS_STEPS = 10      # control steps of the contact-frame PGS run at the BBC's width
# the per-env engine's variants in the parity phase: (label, EngineConfig
# overrides on the BBC env's, K1 launches per substep, K2 per control step)
PER_ENV_VARIANTS = (
    ("jacobi_fast", dict(soa=False), 1, 1), ("pgs_fast", dict(solver="pgs"), 1, 1),
    ("pgs_contact_frames", dict(solver="pgs", fast=False), 0, 0),
    ("jacobi_contact_frames", dict(soa=False, fast=False), 0, 0),
    ("soft_fast", dict(solver="soft"), 0, 1),
    ("soft_contact_frames", dict(solver="soft", fast=False), 0, 0),
    ("grid_direct", dict(soa=False, patch_size=0), 1, 0),
    ("pallas_contact", dict(pallas_contact=True), 1, 1))
VISION_ENVS = 256   # the depth student's width (DepthCfg.camera_num_envs), on 64 courses
VISION_STEPS = 10   # control steps of the vision play phase (cut from 50, then 20, for time)
# the bench and env-ablation phases: agility_tpu_torch/bench.py's lines with one
# warm and one timed iteration and the fast preload; the ablation tools at T
# steps, one rep
BENCH_ITERS = 1
ABLATE_T = 2
# the refresh images, card vs CPU (tests/test_torch_vision.py's rule): the
# pixels raycast.crossing_mask leaves out are counted; the rest are held at
# DEPTH_TOL m (a grazing ray's secant step magnifies a clearance's float32
# difference) and DEPTH_P99 m at the 99th percentile
DEPTH_TOL = 1e-3
DEPTH_P99 = 1e-5
TRAIN_TOL = 1e-4    # card vs CPU, relative, per train stage
# the disc update's parameters: a trunk unit whose pre-activation lies within
# rounding of zero on some row sends the two sides' gradients apart there
# (tests/test_torch_train.py measured 1.9e-4 against the JAX package)
DISC_PARAM_TOL = 1e-3
# the training rollout's rewards, values, log-probs, means and ring rows, card
# vs CPU, relative (two-norms over the envs that did not reset): the states
# are held to SOA_TOL, and the task reward's acceleration and torque terms
# magnify their differences
ROLLOUT_TOL = 1e-2
SOA_TOL = dict(base_pos=5e-4, base_quat=5e-4, dof_pos=1e-3, u=3e-2)
# DDP parity, 2 ranks against 1 (tests/test_dist.py:31-36,61-66): rollout/r_total
# relative, the parameters relative and absolute, the per-env end states absolute
DDP_TOL = dict(r_total=1e-4, rtol=1e-3, atol=1e-4, state=1e-5)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 << 20     # written between flushed calls: five times the 50 MB L2


def cuda_ms(fn, reps=30, warmup=5, flush=False):
    """Median milliseconds of fn() on the card, CUDA events around each call.
    With `flush`, a 256 MB buffer is written before each call, so that its
    inputs come from device memory and not from the L2, and the card is kept
    busy (torch.cuda._sleep) while the host enqueues the write and the call,
    so that the events time the kernel and not the wrapper's host code."""
    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda") if flush else None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush:
            torch.cuda._sleep(1_000_000)
            buf.fill_(1)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved, flops=0):
    """(ms, what bounds it): the least time the card could take to move
    `moved` bytes and do `flops` float32 operations."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn, plain, moved, flops=0):
    """The kernel's warm and flushed times, the plain version's, the bound and
    the share of the bound (from the flushed time)."""
    ms, flushed = cuda_ms(fn), cuda_ms(fn, flush=True)
    bound_ms, by = bound(moved, flops)
    return dict(ms=ms, flushed_ms=flushed, plain_ms=cuda_ms(plain), bytes=moved,
                bound_ms=bound_ms, bound_by=by, share=bound_ms / flushed)


def fmt_times(r):
    return (f"kernel {r['ms']:.4f} ms warm, {r['flushed_ms']:.4f} ms flushed, plain torch "
            f"{r['plain_ms']:.4f} ms; {r['bytes']} bytes, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), share of bound {100 * r['share']:.1f}%")


def window_reads(grid, names, rows, cols):
    """(distinct cells, {surface: distinct 32-byte sectors}) among the grid
    cells at index tensors rows, cols (broadcast together), for each surface
    in `names`: a reading of what the reads touch in memory beside the
    bound's bytes (each surface starts 32-byte aligned)."""
    W = grid.height.shape[1]
    lin = torch.unique((rows * W + cols).reshape(-1))
    sectors = {f: int(torch.unique(lin * getattr(grid, f).element_size() // 32).numel())
               for f in names}
    return int(lin.numel()), sectors


def bbc_case(num_envs=NUM_ENVS, device="cuda"):
    """The BBC play env at the BBC path's width, its initial env states and
    its EnvParams (no heightfield weights)."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv

    cfg = registry.apply_overrides(registry.get("go2_locomotion")[0](),
                                   **{"env.num_envs": num_envs,
                                      "env.mocap_category": ("trot",)})
    env = Go2LocomotionEnv(cfg, device, seed=0)
    return env, env.init_state().sim, env.params


def tsc_env(num_envs, courses, device="cuda"):
    """The TSC play env and hierarchical policy, built as play_tsc builds them."""
    from agility_tpu_torch.cli import play_tsc

    args = play_tsc.get_args(["--device", device, "--num_envs", str(num_envs), "--courses",
                              str(courses), "--checkpoint", TSC_CHECKPOINT,
                              "--bbc_path", TSC_BBC])
    env, policy, _ = play_tsc.build(args)
    return env, policy


def press_into_roof(env, s, n):
    """State `s` with its first `n` envs at the middle goal of their course's
    tunnel, trunk pressed into the roof: the roof is 0.8 m over the tunnel's
    centre line, so a base at 0.78 m pushes the base-link spheres into it."""
    from agility_tpu_torch.terrain import obstacle as obst

    tunnel = obst.OBST_TYPES.index("tunnel")
    e = torch.arange(n, device=env.device)
    station = torch.argmax((env.obst_types[e] == tunnel).long(), dim=1)
    gidx = station * env.num_goals + 2
    pos = s.sim.base_pos.clone()
    pos[e, :2] = env.env_goals[e, gidx, :2]
    pos[e, 2] = 0.78
    s = s._replace(sim=s.sim._replace(base_pos=pos),
                   cur_goal_idx=s.cur_goal_idx.index_put((e,), gidx))
    return s._replace(cur_goals=env._gather_goals(s, s.cur_goal_idx),
                      next_goals=env._gather_goals(s, s.cur_goal_idx + 1))


def tsc_case(num_envs=TSC_ENVS, courses=64, under_roof=64, device="cuda"):
    """The TSC play env at the TSC path's width, its initial env states with
    `under_roof` envs pressed into the tunnel roof, and its EnvParams with
    the states' heightfield weights."""
    env, _ = tsc_env(num_envs, courses, device)
    s = press_into_roof(env, env.init_state(), under_roof)
    return env, s.sim, env.base_params._replace(hf_weights=env._weights(s))


def k1_inputs(env, s, params, lam0_warm):
    """K1's inputs from the port's SoA code on env states `s` (a batch of
    EnvState) under `params`, one substep in (so lam0 is the previous
    substep's impulses when `lam0_warm`)."""
    from agility_tpu_torch.physics import engine as eng
    from agility_tpu_torch.physics import soa

    ctl = eng.Control(target=env.mc.default_dof_pos.expand(env.num_envs, 12),
                      kp=env.kp, kd=env.kd)
    ecfg = env.engine_cfg
    sd, args, _ = soa.batch_inputs(ecfg, env.grid, s, ctl, params)
    sd, _, _, lam = soa.substep(env.mc, ecfg, sd, *args)
    p = soa.pre_contact(env.mc, ecfg, sd, *args)
    return soa.contact_problem(p["phi"], p["n"], p["r"], p["lever"], p["f"], p["u_free"],
                               args[3]["friction"], ecfg.dt, lam0=lam if lam0_warm else None,
                               **soa.contact_kwargs(ecfg))


def k1_check(label, args, iters, S, ceiling, warm=False):
    """K1 against its plain version on inputs `args` (`iters` sweeps from
    lam0, nonzero where `warm`): the error gate, two calls the same bits,
    contacts active (and ceiling rows past the S sphere rows where
    `ceiling`), and the timings."""
    from agility_tpu_torch.kernels import contact_lcp as k1

    kw = dict(iters=iters, relax=0.6)
    out = k1.contact_lcp(*args, **kw)
    again = k1.contact_lcp(*args, **kw)
    ref = k1.contact_lcp_reference(*args, **kw)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / max(scale, 1e-30)
    same = torch.equal(out, again)
    n_active = int(args[4].sum())
    n_ceil = int(args[4][:, S:].sum())
    lam0_max = float(args[7].abs().max())
    N, M = args[1].shape
    # each input read once and lam written once; a sweep is one (M x M)
    # matrix-vector product per env
    t = timed(lambda: k1.contact_lcp(*args, **kw), lambda: k1.contact_lcp_reference(*args, **kw),
              nbytes(*args, out), 2 * iters * N * M * M)
    cfg = k1.device_launch_config(N, M // 3, args[0].device)
    print(f"K1 {label}: N={N} S={M // 3} iters={iters} launch {cfg}; "
          f"active contacts {n_active} (ceiling rows {n_ceil}) max|lam0| "
          f"{lam0_max:.4g} max|lam| {scale:.4g} max abs err {err:.3e} rel {rel:.3e} "
          f"(tol {K1_RTOL:g}), two calls bit-identical {same}; G {nbytes(args[0])} "
          f"bytes; {fmt_times(t)}", flush=True)
    if not np.isfinite(err) or rel > K1_RTOL:
        raise SystemExit(f"K1 {label}: kernel disagrees with the plain version")
    if not same:
        raise SystemExit(f"K1 {label}: two calls on the same inputs differ")
    if n_active == 0 or (warm and lam0_max == 0.0):
        raise SystemExit(f"K1 {label}: inputs exercise no contact")
    if ceiling and n_ceil == 0:
        raise SystemExit(f"K1 {label}: no ceiling row is active")
    return dict(max_abs_err=err, rel_err=rel, **t)


def phase_k1(cases):
    """K1 against its plain version on each (path, env, states, params) case,
    as the SoA substep builds its inputs, warm and cold; the ceiling rows
    (past the env's S sphere rows) must be active where the grid has a
    ceiling."""
    from agility_tpu_torch.physics import soa

    rows = {}
    for path, env, s, params in cases:
        S = soa.consts_of(env.mc).S
        for mode, warm, iters in (("warm", True, 5), ("cold", False, 10)):
            label = f"{path} {mode}"
            rows[label] = k1_check(label, k1_inputs(env, s, params, warm), iters, S,
                                   env.grid.ceiling is not None, warm)
    return rows


def k1_per_env_inputs(env, s, params, iters):
    """K1's inputs on the per-env route (kernels/contact_lcp.per_env_problem)
    from the fast path's data on env states `s`, one substep in: G =
    JpT^T M^-1 JpT from engine._pre_contact, cold."""
    from agility_tpu_torch.kernels import contact_lcp as k1
    from agility_tpu_torch.kernels.terrain_window import terrain_window
    from agility_tpu_torch.physics import dynamics as dyn
    from agility_tpu_torch.physics import engine as eng
    from agility_tpu_torch.physics import soa

    ecfg = dataclasses.replace(env.engine_cfg, solver="pgs", warm_start=False,
                               jacobi_iters=iters)
    ctl = eng.Control(target=env.mc.default_dof_pos.expand(env.num_envs, 12), kp=env.kp,
                      kd=env.kd)
    patch = terrain_window(env.grid, s.base_pos[:, :2].contiguous(), ecfg.patch_size,
                           params.hf_weights)
    s, _, _ = eng.substep(env.mc, ecfg, env.grid, s, ctl, params, patch)
    p = eng._pre_contact(env.mc, ecfg, env.grid, s, ctl, params, patch)
    G = p.JpT.transpose(1, 2) @ dyn.solve_mass(p.factors, p.JpT)
    return k1.per_env_problem(p.phi, p.normals, p.JpT, G, p.u_free, params.friction, ecfg.dt,
                              **soa.contact_kwargs(ecfg))


def phase_k1_per_env(env, s, params, iters=10):
    """K1 on the per-env route at the BBC's width (N = 4096, S = 24, the
    per-env path's 2 x 5 cold sweeps), against its plain version with the
    same gate as phase_k1."""
    from agility_tpu_torch.physics import soa

    label = "bbc per-env cold"
    return {label: k1_check(label, k1_per_env_inputs(env, s, params, iters), iters,
                            soa.consts_of(env.mc).S, False)}


def course_case(n, seed=0, env=None):
    """The default 64-course world on the card (the TSC slice's world: play
    seed 0), or TSC env `env`'s world, n centres on its goal waypoints
    (which lie on the obstacles) jittered by up to 0.3 m, per-env weights
    over the bar, tire and tilt ranges, and each env's 132 scan points at a
    random heading."""
    from agility_tpu_torch.physics import heightfield as hf
    from agility_tpu_torch.terrain import obstacle as obst

    cfg = obst.ObstacleCfg()
    if env is None:
        world = obst.generate(cfg, seed=seed)
        grid = hf.from_numpy(world.height, world.hscale, world.origin, "cuda",
                             layer_id=world.layer_id, lever=world.lever, ceiling=world.ceil,
                             ceiling_layer=world.ceil_layer)
    else:
        world, grid = env.world, env.grid
    rng = np.random.default_rng(seed)
    goals = world.goals[:, :, :2].reshape(-1, 2)
    c = goals[np.arange(n) % len(goals)] + rng.uniform(-0.3, 0.3, (n, 2))
    w = np.stack([rng.uniform(0.05, 0.3, n), rng.uniform(0.4, 0.65, n),
                  rng.uniform(-obst.SEESAW_THETA_MAX, obst.SEESAW_THETA_MAX, n)], -1)
    gx, gy = np.meshgrid(cfg.measured_points_x, cfg.measured_points_y, indexing="ij")
    local = np.stack([gx.ravel(), gy.ravel()], -1)                       # (132, 2)
    yaw = rng.uniform(-np.pi, np.pi, n)
    rot = np.stack([np.stack([np.cos(yaw), -np.sin(yaw)], -1),
                    np.stack([np.sin(yaw), np.cos(yaw)], -1)], -2)       # (n, 2, 2)
    pts = c[:, None, :] + np.einsum("nij,kj->nki", rot, local)
    scan_c = c + np.einsum("nij,j->ni", rot, local.mean(0))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device="cuda").contiguous()
    return grid, f32(c), f32(w), f32(scan_c), f32(pts[..., 0]), f32(pts[..., 1])


def k2_cases(bbc):
    """K2's inputs at every path's shape, (label, grid, centres, size,
    weights): the TSC's (course world, weights, ceiling, N = 6144 windows of
    32 on goal waypoints), the depth student's (the same at N = 256), the
    BBC's (`bbc`: its env and initial states; one surface, no weights,
    every other centre anywhere on the map or up to 1 m off it) and the
    same on the bench's BBC grid (agility_tpu_torch/bench.py:bbc_config, the
    4 x 4 terrain with a 10 m border: 600 x 600 cells, N = 4096)."""
    from agility_tpu_torch.bench import bbc_config
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv

    grid, c, w, _, _, _ = course_case(TSC_ENVS)
    vgrid, vc, vw, _, _, _ = course_case(VISION_ENVS)
    benv = Go2LocomotionEnv(bbc_config(NUM_ENVS), "cuda", seed=1)
    return [("tsc", grid, c, 32, w), ("tsc_vision", vgrid, vc, 32, vw),
            bbc_window_case("bbc", *bbc),
            bbc_window_case("bbc_bench", benv, benv.init_state().sim, benv.params)]


def bbc_window_case(label, env, s, params):
    """K2's inputs on a BBC env's grid (one surface, no weights): windows
    at the spawn points of states `s` and, for every other env, anywhere on
    the map or up to 1 m off it."""
    bgrid, size = env.grid, env.engine_cfg.patch_size
    H, W = bgrid.height.shape
    bc = s.base_pos[:, :2].clone()
    lo = torch.tensor(bgrid.origin, device=bc.device) - 1.0
    span = torch.tensor([H, W], device=bc.device) * bgrid.hscale + 2.0
    g = torch.Generator(device=bc.device).manual_seed(0)
    bc[1::2] = lo + span * torch.rand(bc[1::2].shape, generator=g, device=bc.device)
    return (label, bgrid, bc.contiguous(), size, params.hf_weights)


def k2_reads(grid, ref, w):
    """K2's reads from the plain version's patch `ref`: (distinct cells
    under the windows, sectors per surface read, the surfaces read)."""
    from agility_tpu_torch.kernels import terrain_window as k2

    names, _ = k2.used_surfaces(grid, w)
    ar = torch.arange(ref.values.shape[1], device=ref.x0.device)
    cells, sectors = window_reads(grid, names, (ref.x0[:, None] + ar)[:, :, None],
                                  (ref.y0[:, None] + ar)[:, None, :])
    return cells, sectors, names


def k2_moved(grid, c, w, out, cells, names):
    """K2's bytes: each distinct cell of each surface read once, the
    centres and weights read, the windows and origins written."""
    per_cell = sum(getattr(grid, f).element_size() for f in names)
    fields = ("values", "x0", "y0") + (("ceil",) if out.ceil is not None else ())
    return cells * per_cell + nbytes(c, w, *(getattr(out, f) for f in fields))


def _k2_check(label, grid, c, size, w):
    """K2 against its plain version on one input: exactly equal floor,
    ceiling and origins, two calls the same bits.  Returns the plain
    version's patch and the row."""
    from agility_tpu_torch.kernels import terrain_window as k2

    got = k2.terrain_window(grid, c, size, w)
    again = k2.terrain_window(grid, c, size, w)
    ref = k2.terrain_window_reference(grid, c, size, w)
    torch.cuda.synchronize()
    fields = ("values", "x0", "y0") + (("ceil",) if ref.ceil is not None else ())
    err = max(float((getattr(got, f) - getattr(ref, f)).abs().max()) for f in fields)
    same = all(torch.equal(getattr(got, f), getattr(ref, f)) for f in fields)
    twice = all(torch.equal(getattr(got, f), getattr(again, f)) for f in fields)
    cells, sectors, names = k2_reads(grid, ref, w)
    t = timed(lambda: k2.terrain_window(grid, c, size, w),
              lambda: k2.terrain_window_reference(grid, c, size, w),
              k2_moved(grid, c, w, got, cells, names))
    cfg = k2.device_launch_config(c.shape[0], ref.values.shape[1], grid, w, c.device)
    print(f"K2 {label}: N={c.shape[0]} windows of {size} on the {tuple(grid.height.shape)} "
          f"grid, weights {None if w is None else tuple(w.shape)}; launch {cfg}; {cells} "
          f"distinct cells under the windows, 32-byte sectors touched per surface {sectors}; "
          f"max abs err {err:.3e}, exactly equal {same}, two calls bit-identical {twice}; "
          f"{fmt_times(t)}", flush=True)
    if not same:
        raise SystemExit(f"K2 {label}: kernel differs from the plain version")
    if not twice:
        raise SystemExit(f"K2 {label}: two calls on the same inputs differ")
    return ref, dict(max_abs_err=err, cells=cells, sectors=sectors, routes=cfg["routes"], **t)


def phase_k2(cases):
    """K2 on each (label, grid, centres, size, weights) case: at the TSC
    paths' shapes (course world, weights, ceiling; the teacher's N and the
    depth student's) and at the BBC path's (one surface, no weights, windows
    clamped at the map's edge)."""
    from agility_tpu_torch.physics import heightfield as hf

    rows = {}
    for label, grid, c, size, w in cases:
        ref, rows[label] = _k2_check(label, grid, c, size, w)
        ar = torch.arange(size, device="cuda")
        ix, iy = (ref.x0[:, None] + ar)[:, :, None], (ref.y0[:, None] + ar)[:, None, :]
        if label.startswith("tsc"):
            counts = dict(layer=int((grid.layer_id[ix, iy] != 0).sum()),
                          lever=int((grid.lever[ix, iy] != 0).sum()),
                          ceiling=int((grid.ceiling[ix, iy] < hf.NO_CEILING).sum()))
            print(f"K2 {label}: cells under the windows {counts}", flush=True)
            if min(counts.values()) == 0:
                raise SystemExit(f"K2 {label}: the windows cover no layer, lever or ceiling "
                                 "cell")
        else:
            H, W = grid.height.shape
            clamped = int(((ref.x0 == 0) | (ref.x0 == H - size) | (ref.y0 == 0)
                           | (ref.y0 == W - size)).sum())
            print(f"K2 {label}: {clamped} windows clamped at the map's edge", flush=True)
            if clamped == 0:
                raise SystemExit(f"K2 {label}: no window clamps at the map's edge")
    return rows


def k3_case(n, env=None):
    """K3's inputs at a TSC path's shape, N = `n` scans: (grid, scan
    centres, window 34, weights, px, py) on the course world (`env`'s, if
    given)."""
    grid, _, w, sc, px, py = course_case(n, env=env)
    return grid, sc, 34, w, px, py


def k3_reads(grid, args):
    """K3's reads: (distinct nodes read, sectors per surface, the surfaces
    read, the scans' floor nodes (rows, cols))."""
    from agility_tpu_torch.kernels import scandots as k3
    from agility_tpu_torch.physics import patch as pt

    g, sc, size, w, px, py = args
    r, col = pt.scandot_nodes(g, sc, size, px, py)
    names, _ = k3.used_surfaces(g, w)
    # each point reads its node and the +x and +y neighbours
    cells, sectors = window_reads(g, names, torch.stack([r, r + 1, r]),
                                  torch.stack([col, col, col + 1]))
    return cells, sectors, names, (r, col)


def k3_moved(args, out, cells, names):
    """K3's bytes: each distinct node of each surface read once, the
    centres, weights and points read, the scandots written."""
    g, sc, _, w, px, py = args
    return cells * sum(getattr(g, f).element_size() for f in names) + nbytes(sc, w, px, py, out)


def phase_k3(cases):
    """K3 against its plain version on each (label, inputs) case: at the
    TSC paths' shapes, the teacher's N = 6144 scans and the depth student's
    N = 256."""
    from agility_tpu_torch.kernels import scandots as k3

    rows = {}
    for label, args in cases:
        grid, sc, size, w, px, py = args
        got = k3.scandots(*args)
        again = k3.scandots(*args)
        ref = k3.scandots_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same, twice = torch.equal(got, ref), torch.equal(got, again)
        cells, sectors, names, (r, col) = k3_reads(grid, args)
        counts = dict(layer=int((grid.layer_id[r, col] != 0).sum()),
                      lever=int((grid.lever[r, col] != 0).sum()))
        t = timed(lambda: k3.scandots(*args), lambda: k3.scandots_reference(*args),
                  k3_moved(args, got, cells, names))
        cfg = dict(k3.launch_config(sc.shape[0], px.shape[1], size),
                   routes={s: k3.ROUTE for s in names})
        print(f"K3 {label}: N={sc.shape[0]} scans x {px.shape[1]} points, window {size}, floor "
              f"nodes on {counts}; launch {cfg}; {cells} distinct nodes read, 32-byte sectors "
              f"touched per surface {sectors}; max abs err {err:.3e}, exactly equal {same}, two "
              f"calls bit-identical {twice}; {fmt_times(t)}", flush=True)
        if not same:
            raise SystemExit(f"K3 {label}: kernel differs from the plain version")
        if not twice:
            raise SystemExit(f"K3 {label}: two calls on the same inputs differ")
        if min(counts.values()) == 0:
            raise SystemExit(f"K3 {label}: the scans cross no layer or lever cell")
        rows[label] = dict(max_abs_err=err, cells=cells, sectors=sectors,
                           routes=cfg["routes"], **t)
    return rows


def phase_bench(num_envs, tsc_envs, iters):
    """agility_tpu_torch/bench.py's two lines on the card at full width
    (bench_bbc at `num_envs` on the bench's BBC config, bench_tsc at
    `tsc_envs` on 64 courses), `iters` timed iterations after one warm
    one, the fast preload: each line has the root bench's keys with finite
    values > 0 and its value and vs_baseline are the root bench's accounting
    of the measured mean; K1 launched 4 times and K2 once a control step
    (the env's init_state step and every rollout step), K3 once a step on
    the TSC line and never on the BBC's.  Returns {path: launches}."""
    from agility_tpu_torch import bench

    T = bench.AlgoCfg().num_steps_per_env
    steps = T * (iters + 1) + 1
    launches = {}
    for path, run, tsc in (
            ("bench_bbc", lambda: bench.bench_bbc("cuda", num_envs, iters, fast=True), False),
            ("bench_tsc", lambda: bench.bench_tsc("cuda", tsc_envs, iters), True)):
        _counts_zero()
        out, dt = run()
        launches[path] = _counts()
        rate = T * (tsc_envs if tsc else num_envs) / dt
        base = bench.BASELINES[out["metric"]]
        want = dict(contact_lcp=4 * steps, terrain_window=steps, scandots=steps if tsc else 0)
        print(f"bench {path}: {json.dumps(out)}; {dt:.3f} s a timed iteration; launches "
              f"{launches[path]} (want {want}, {steps} control steps)", flush=True)
        keys = {"metric", "value", "unit", "vs_baseline"}
        if not keys <= set(out) or out["unit"] != "env-steps/s":
            raise SystemExit(f"bench {path}: the line lacks the root bench's keys")
        if not (np.isfinite(out["value"]) and out["value"] > 0 and out["vs_baseline"] > 0
                and all(np.isfinite(t) and t > 0 for t in out["iter_ms"])):
            raise SystemExit(f"bench {path}: a value is not finite and positive")
        if out["value"] != round(rate, 1) or out["vs_baseline"] != round(rate / base, 3):
            raise SystemExit(f"bench {path}: value or vs_baseline is not the root bench's "
                             "accounting of the measured mean")
        if launches[path] != want:
            raise SystemExit(f"bench {path}: launches {launches[path]}, want {want}")
    return launches


def phase_env_ablation(num_envs, tsc_envs, T):
    """The env-layer ablation tools (agility_tpu_torch/tools/bench_env_ablate
    and bench_env_ablate_tsc) at full width, `T` steps, one rep: every
    variant's rewards finite; K1 4 and K2 1 a step in each full step, K3
    once a step in the TSC's full step and never under "no
    _measure_heights" or "no _compute_observations" (the stub took
    effect).  Returns {tool: rows}."""
    from agility_tpu_torch import bench
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.tools import bench_env_ablate as bbc_tool
    from agility_tpu_torch.tools import bench_env_ablate_tsc as tsc_tool

    rows = {}
    for name, tool, make in (
            ("bbc", bbc_tool, lambda: Go2LocomotionEnv(bench.bbc_config(num_envs), "cuda")),
            ("tsc", tsc_tool, lambda: Go2AgilityEnv(bench.tsc_config(tsc_envs), "cuda"))):
        print(f"env ablation {name}: {num_envs if name == 'bbc' else tsc_envs} envs, T = {T}, "
              "1 rep", flush=True)
        rows[name], _ = tool.ablate(make(), T, 1)
        by = {r["label"]: r for r in rows[name]}
        bad = [r["label"] for r in rows[name] if not r["finite"]]
        if bad:
            raise SystemExit(f"env ablation {name}: non-finite rewards under {bad}")
        full = by["full step"]["launches"]
        want = dict(contact_lcp=4, terrain_window=1, scandots=1 if name == "tsc" else 0)
        if full != want:
            raise SystemExit(f"env ablation {name}: full step launches {full} a step, want {want}")
        if name == "tsc":
            k3 = {k: by[k]["launches"]["scandots"]
                  for k in ("no _measure_heights", "no _compute_observations")}
            print(f"env ablation tsc: K3 launches a step {k3} (full step 1)", flush=True)
            if any(k3.values()):
                raise SystemExit("env ablation tsc: K3 launched under a stub that removes it")
    return rows


def phase_parity(num_envs=64):
    """One BBC control step on the card (kernels) against the CPU (plain versions)."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.policy import build_policy

    cfg = registry.apply_overrides(registry.get("go2_locomotion")[0](),
                                   **{"env.num_envs": num_envs,
                                      "env.mocap_category": ("trot",)})
    gpu, cpu = Go2LocomotionEnv(cfg, "cuda", seed=0), Go2LocomotionEnv(cfg, "cpu", seed=0)
    pol = build_policy(cfg, device="cuda")
    sg = gpu.init_state()
    acts = pol(sg.obs_buf)
    og, _ = gpu.step(sg, acts)
    oc, _ = cpu.step(_to(sg, "cpu"), acts.cpu())
    errs = {k: float((getattr(og.sim, k).cpu() - getattr(oc.sim, k)).abs().max()) for k in SOA_TOL}
    print(f"parity {num_envs} envs, one BBC control step, card vs CPU: "
          + ", ".join(f"{k} {v:.3e} (tol {SOA_TOL[k]:g})" for k, v in errs.items()), flush=True)
    if not all(np.isfinite(v) and v <= SOA_TOL[k] for k, v in errs.items()):
        raise SystemExit("parity: the card's control step disagrees with the CPU's")


def _to(state, dev):
    """A copy of an env state (LocoState or AgilityState) on `dev`."""
    move = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
    return state._replace(sim=type(state.sim)(*(move(t) for t in state.sim)),
                          **{k: move(getattr(state, k)) for k in state._fields if k != "sim"})


def phase_tsc_parity(num_envs=64, courses=8, under_roof=8):
    """One TSC env step on the card (K1, K2, K3) against the CPU (plain
    versions), from one state with `under_roof` envs in their course's tunnel,
    trunk pressed into the roof."""
    gpu, policy = tsc_env(num_envs, courses)
    cpu = type(gpu)(gpu.cfg, "cpu", seed=0)
    s = press_into_roof(gpu, gpu.init_state(), under_roof)
    s, nc = gpu.set_commands(s, policy.act(s.obs_buf))
    acts = policy.bbc_act(s.obs_bbc_buf, nc)
    sc = _to(s, "cpu")
    og, outg = gpu.step(s, acts)
    oc, outc = cpu.step(sc, acts.cpu())
    keep = ~(outc.reset | outg.reset.cpu())
    errs = {k: float((getattr(og.sim, k).cpu() - getattr(oc.sim, k))[keep].abs().max())
            for k in SOA_TOL}
    errs["terminal_disc_obs"] = float((outg.terminal_disc_obs.cpu()
                                       - outc.terminal_disc_obs).abs().max())
    # the reset envs' pre-reset features: measured 1.6e-4 on an H100, gated
    # at about 6x that
    tol = dict(SOA_TOL, terminal_disc_obs=1e-3)
    n_ceil = _active_ceiling_contacts(cpu, sc)
    print(f"TSC parity {num_envs} envs x {courses} courses, one env step, card vs CPU: "
          f"{n_ceil} active ceiling contacts, {int(outc.reset.sum())} envs reset (CPU) / "
          f"{int(outg.reset.sum())} (card); "
          + ", ".join(f"{k} {v:.3e} (tol {tol[k]:g})" for k, v in errs.items()), flush=True)
    if not torch.equal(outg.reset.cpu(), outc.reset):
        raise SystemExit("TSC parity: the card and the CPU reset different envs")
    if not all(np.isfinite(v) and v <= tol[k] for k, v in errs.items()):
        raise SystemExit("TSC parity: the card's env step disagrees with the CPU's")
    if n_ceil == 0:
        raise SystemExit("TSC parity: no ceiling contact was active")


def _step_errors(gpu, cpu, s, acts, ecfg):
    """One env step under engine config `ecfg` on the card and on the CPU
    from state `s`: (errors over the envs neither side reset, launches on
    the card, resets equal)."""
    gpu.engine_cfg = cpu.engine_cfg = ecfg
    _counts_zero()
    og, outg = gpu.step(s, acts)
    torch.cuda.synchronize()
    launches = _counts()
    oc, outc = cpu.step(_to(s, "cpu"), acts.cpu())
    keep = ~(outc.reset | outg.reset.cpu())
    errs = {k: float((getattr(og.sim, k).cpu() - getattr(oc.sim, k))[keep].abs().max())
            for k in SOA_TOL}
    return errs, launches, torch.equal(outg.reset.cpu(), outc.reset)


def phase_per_env_parity(num_envs=64, courses=8, under_roof=8):
    """One BBC control step of each per-env engine variant (PER_ENV_VARIANTS:
    the world-frame Jacobi solve through K1 for solver jacobi and pgs, PGS
    and Jacobi in contact frames, soft contacts on either path, direct grid
    queries, pallas_contact) on the card against the CPU from one state, at
    tests/test_soa.py's tolerances, with the launches each variant must
    make; then one TSC env step with solver "pgs" on the course world (8
    envs pressed into the tunnel roof): with the fast path's window the
    per-env path sees the ceiling (its rows active), as the JAX package's
    step_batch rules; with fast=False the ceiling keeps it on SoA."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.policy import build_policy
    from agility_tpu_torch.physics import engine as eng

    cfg = registry.apply_overrides(registry.get("go2_locomotion")[0](),
                                   **{"env.num_envs": num_envs,
                                      "env.mocap_category": ("trot",)})
    gpu, cpu = Go2LocomotionEnv(cfg, "cuda", seed=0), Go2LocomotionEnv(cfg, "cpu", seed=0)
    s = gpu.init_state()
    acts = build_policy(cfg, device="cuda")(s.obs_buf)
    base, dec = gpu.engine_cfg, gpu.engine_cfg.decimation
    cases = [(label, gpu, cpu, s, acts, dataclasses.replace(base, **kw), False,
              dict(contact_lcp=k1 * dec, terrain_window=k2, scandots=0))
             for label, kw, k1, k2 in PER_ENV_VARIANTS]
    tg, policy = tsc_env(num_envs, courses)
    tc = type(tg)(tg.cfg, "cpu", seed=0)
    ts = press_into_roof(tg, tg.init_state(), under_roof)
    ts, nc = tg.set_commands(ts, policy.act(ts.obs_buf))
    tacts = policy.bbc_act(ts.obs_bbc_buf, nc)
    tsc_want = dict(contact_lcp=dec, terrain_window=1, scandots=1)
    cases += [("tsc_pgs_fast", tg, tc, ts, tacts,
               dataclasses.replace(tg.engine_cfg, solver="pgs"), False, tsc_want),
              ("tsc_pgs_contact_frames_soa", tg, tc, ts, tacts,
               dataclasses.replace(tg.engine_cfg, solver="pgs", fast=False), True, tsc_want)]
    for label, g, c, st, a, ecfg, soa_path, want in cases:
        errs, launches, same_resets = _step_errors(g, c, st, a, ecfg)
        n_ceil = (_per_env_ceiling_contacts(c, _to(st, "cpu"), ecfg)
                  if label == "tsc_pgs_fast" else None)
        print(f"per-env parity {label}: {num_envs} envs, one env step card vs CPU, SoA path "
              f"{eng.uses_soa(ecfg, g.grid)}, launches {launches} (want {want})"
              + ("" if n_ceil is None else f", active ceiling rows {n_ceil}") + "; "
              + ", ".join(f"{k} {v:.3e} (tol {SOA_TOL[k]:g})" for k, v in errs.items()),
              flush=True)
        if eng.uses_soa(ecfg, g.grid) != soa_path:
            raise SystemExit(f"per-env parity {label}: took the wrong path")
        if launches != want or not same_resets:
            raise SystemExit(f"per-env parity {label}: launch counts or resets differ")
        if not all(np.isfinite(v) and v <= SOA_TOL[k] for k, v in errs.items()):
            raise SystemExit(f"per-env parity {label}: the card's step disagrees with the CPU's")
        if n_ceil == 0:
            raise SystemExit(f"per-env parity {label}: no ceiling row is active")


def _per_env_ceiling_contacts(env, s, ecfg):
    """Ceiling rows with phi < 0 on the per-env fast path in TSC state `s`."""
    from agility_tpu_torch.kernels.terrain_window import terrain_window
    from agility_tpu_torch.physics import engine as eng
    from agility_tpu_torch.physics import soa

    ctl = eng.Control(env.mc.default_dof_pos.expand(env.num_envs, 12), env.kp, env.kd)
    params = env.base_params._replace(hf_weights=env._weights(s))
    patch = terrain_window(env.grid, s.sim.base_pos[:, :2].contiguous(), ecfg.patch_size,
                           params.hf_weights)
    p = eng._pre_contact(env.mc, ecfg, env.grid, s.sim, ctl, params, patch)
    return int((p.phi[:, soa.consts_of(env.mc).S:] < 0).sum())


def _active_ceiling_contacts(env, s):
    """Ceiling contact rows with phi < 0 in state `s` (the contact geometry
    does not depend on the control), on the env's device."""
    from agility_tpu_torch.physics import engine as eng
    from agility_tpu_torch.physics import soa

    ctl = eng.Control(env.mc.default_dof_pos.expand(env.num_envs, 12), env.kp, env.kd)
    params = env.base_params._replace(hf_weights=env._weights(s))
    sd, args, _ = soa.batch_inputs(env.engine_cfg, env.grid, s.sim, ctl, params)
    p = soa.pre_contact(env.mc, env.engine_cfg, sd, *args)
    return int((p["phi"][soa.consts_of(env.mc).S:] < 0).sum())


def _counts_zero():
    from agility_tpu_torch.kernels import contact_lcp as k1
    from agility_tpu_torch.kernels import scandots as k3
    from agility_tpu_torch.kernels import terrain_window as k2

    k1.contact_lcp.launches = k2.terrain_window.launches = k3.scandots.launches = 0


def _counts():
    from agility_tpu_torch.kernels import launch_counts

    return launch_counts()


def phase_slice(num_envs, steps):
    from agility_tpu_torch.cli import play_bbc
    from agility_tpu_torch.physics import heightfield as hf

    args = play_bbc.get_args(["--device", "cuda", "--num_envs", str(num_envs),
                              "--checkpoint", CHECKPOINT, "--mode", "trot", "--vx", "1.0",
                              "--steps", str(steps), "--gait_bands", GAIT_BANDS])
    _counts_zero()
    res = play_bbc.run(args)
    launches = _counts()
    gait_reading(res, num_envs, steps)
    s = res["state"]
    finite = all(bool(torch.isfinite(t).all()) for t in (*s.sim, s.obs_buf))
    pos = s.sim.base_pos
    # height over the terrain under the base: on this map the terrain under
    # the spawn points has a median height of 0.32 m, so world z alone does
    # not say whether a robot stands
    root_h = pos[:, 2] - hf.sample_height(res["env"].grid, pos[:, 0], pos[:, 1])
    med_h, med_z = float(root_h.median()), float(pos[:, 2].median())
    print(f"BBC slice: {num_envs} envs x {steps} control steps, launches {launches} "
          f"(substeps run {res['substeps']}), all states finite {finite}, "
          f"median base height over terrain {med_h:.4f} m (world z {med_z:.4f} m), "
          f"{res['env_steps_per_s']:.1f} env-steps/s on {torch.cuda.get_device_name(0)}",
          flush=True)
    if launches["contact_lcp"] != res["substeps"]:
        raise SystemExit("BBC slice: the K1 launch count differs from the substeps run")
    if launches["terrain_window"] != steps + 1:
        raise SystemExit("BBC slice: the K2 launch count differs from the control steps run")
    if not finite:
        raise SystemExit("BBC slice: non-finite state")
    if not 0.15 <= med_h <= 0.45:
        raise SystemExit("BBC slice: median base height over terrain outside [0.15, 0.45] m")
    return launches, dict(play_profile("BBC slice", res, num_envs), rate=res["env_steps_per_s"])


def step_profile(label, step, s, step_ms, steps=2):
    """Device ops and busy time per control step (kernel, copy and fill
    durations; counted as tools/count_ops.ops_of counts them) of `steps` calls
    s = step(s) under torch.profiler, against the unprofiled step time
    `step_ms`.  A reading, not a gate."""
    from torch.profiler import ProfilerActivity, profile as trace

    # the device activity alone, its raw events read: tracing the host's
    # ~63k ops a step and building their event tree took seconds a step
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            s = step(s)
        torch.cuda.synchronize()
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.end_ns() - e.start_ns() for e in dev) / 1e6 / steps
    r = dict(ops=len(dev) / steps, busy_ms=busy_ms, step_ms=step_ms, busy=busy_ms / step_ms)
    print(f"{label} profile: {r['ops']:.0f} device ops per control step, device busy "
          f"{busy_ms:.2f} ms per step, {100 * r['busy']:.1f}% of the unprofiled "
          f"{step_ms:.1f} ms step", flush=True)
    return r


def play_profile(label, res, num_envs, steps=2):
    """step_profile of a play_bbc rollout's env, policy and command hold."""
    env, policy, hold = res["env"], res["policy"], res["hold"]

    def step(s):
        s = hold(s)
        return env.step(s, policy(s.obs_buf))[0]

    return step_profile(label, step, res["state"], num_envs / res["env_steps_per_s"] * 1e3,
                        steps)


def _height_over_terrain(env, s):
    """Median base height over the terrain under it, m (a BBC env)."""
    from agility_tpu_torch.physics import heightfield as hf

    pos = s.sim.base_pos
    return float((pos[:, 2] - hf.sample_height(env.grid, pos[:, 0], pos[:, 1])).median())


def phase_per_env_slice(num_envs, steps, solver, soa_reading):
    """play_bbc's build and rollout at the BBC's width with sim.solver set
    (a build keyword; the CLI has no flag for it), which puts the env on the
    per-env engine: "pgs" is the world-frame Jacobi solve through K1 (2 x 5
    cold sweeps a substep), "soft" the penalty contacts.  Gates: K1 launches
    = substeps for pgs and 0 for soft, K2 = control steps + 1, finite
    states, median base height over the terrain in [0.15, 0.45] m.  Prints
    env-steps/s, device ops per control step and the busy share beside the
    SoA slice's from this call."""
    from agility_tpu_torch.cli import play_bbc
    from agility_tpu_torch.physics import engine as eng

    label = f"BBC per-env slice ({solver})"
    args = play_bbc.get_args(["--device", "cuda", "--num_envs", str(num_envs), "--checkpoint",
                              CHECKPOINT, "--mode", "trot", "--vx", "1.0", "--steps", str(steps)])
    _counts_zero()
    res = play_bbc.run(args, overrides={"sim.solver": solver})
    launches = _counts()
    env, s = res["env"], res["state"]
    finite = all(bool(torch.isfinite(t).all()) for t in (*s.sim, s.obs_buf))
    med_h = _height_over_terrain(env, s)
    want = dict(contact_lcp=res["substeps"] if solver != "soft" else 0,
                terrain_window=steps + 1, scandots=0)
    prof = play_profile(label, res, num_envs)
    print(f"{label}: {num_envs} envs x {steps} control steps, solver "
          f"{env.engine_cfg.solver}; launches {launches} (want {want}), all states finite "
          f"{finite}, median base height over terrain {med_h:.4f} m; "
          f"{res['env_steps_per_s']:.1f} env-steps/s (the SoA slice in this call: "
          f"{soa_reading['rate']:.1f}), device ops per control step {prof['ops']:.0f} "
          f"(SoA {soa_reading['ops']:.0f}), busy {100 * prof['busy']:.1f}% "
          f"(SoA {100 * soa_reading['busy']:.1f}%) on {torch.cuda.get_device_name(0)}",
          flush=True)
    if eng.uses_soa(env.engine_cfg, env.grid):
        raise SystemExit(f"{label}: the config took the SoA path")
    if launches != want:
        raise SystemExit(f"{label}: a kernel's launch count differs from the steps run")
    if not finite:
        raise SystemExit(f"{label}: non-finite state")
    if not 0.15 <= med_h <= 0.45:
        raise SystemExit(f"{label}: median base height over terrain outside [0.15, 0.45] m")
    return launches, dict(prof, rate=res["env_steps_per_s"])


def phase_pgs_contact_frames(num_envs, steps):
    """The true projected Gauss-Seidel solve (EngineConfig solver "pgs",
    fast=False: contact frames, direct grid queries, serial over the 24
    contacts in each of 4 sweeps; plain torch, no kernel) at the BBC's
    width for `steps` control steps of play_bbc's env and policy, timed
    (synchronised host clock) and one step profiled.  Gates: no K1 or K2
    launch, finite states, median base height over the terrain in [0.15,
    0.45] m."""
    from agility_tpu_torch.cli import play_bbc
    from agility_tpu_torch.physics import engine as eng

    args = play_bbc.get_args(["--device", "cuda", "--num_envs", str(num_envs), "--checkpoint",
                              CHECKPOINT, "--mode", "trot", "--vx", "1.0"])
    env, policy, _, hold = play_bbc.build(args)
    env.engine_cfg = dataclasses.replace(env.engine_cfg, solver="pgs", fast=False)

    def step(s):
        s = hold(s)
        return env.step(s, policy(s.obs_buf))[0]

    s = env.init_state()
    torch.cuda.synchronize()
    _counts_zero()
    t0 = time.perf_counter()
    for _ in range(steps):
        s = step(s)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launches = _counts()
    rate = num_envs / step_ms * 1e3
    prof = step_profile("PGS contact frames", step, s, step_ms, steps=1)
    finite = all(bool(torch.isfinite(t).all()) for t in (*s.sim, s.obs_buf))
    med_h = _height_over_terrain(env, s)
    print(f"PGS contact frames: {num_envs} envs x {steps} control steps, {step_ms:.1f} ms a "
          f"step, {rate:.1f} env-steps/s, launches {launches}, all states finite {finite}, "
          f"median base height over terrain {med_h:.4f} m", flush=True)
    if eng.uses_soa(env.engine_cfg, env.grid) or any(launches.values()):
        raise SystemExit("PGS contact frames: the run took a kernel or the SoA path")
    if not finite or not 0.15 <= med_h <= 0.45:
        raise SystemExit("PGS contact frames: non-finite state or base height outside "
                         "[0.15, 0.45] m")
    return launches, dict(prof, rate=rate)


def gait_reading(res, num_envs, steps):
    """The BBC slice's gait report (play_bbc printed it) beside the JAX
    package's trot line; fails unless the stats are finite and physical.
    The verdict is printed, not gated."""
    stats, bands, verdict = res["gait"]
    dt = res["env"].dt
    duty, hz, sync = np.asarray(stats["duty"]), np.asarray(stats["stride_hz"]), stats["diag_sync"]
    with open(JAX_GAIT_REPORT) as f:
        blocks = f.read().split("=== mode ")
    jax_trot = next(b for b in blocks if b.startswith("trot")).strip().splitlines()
    from agility_tpu_torch.cli.play_bbc import TRANSIENT

    skipped = f"the first {TRANSIENT} skipped" if steps > 2 * TRANSIENT else "none skipped"
    print(f"BBC slice gait: trot, vx 1.0, bbc_15k, {num_envs} envs x {steps} steps, {skipped}: "
          f"duty FL/FR/RL/RR {np.array2string(duty, precision=4)} (mean "
          f"{duty.mean():.4f}), stride_hz {np.array2string(hz, precision=4)} (mean "
          f"{hz.mean():.4f}), diag_sync {sync:.4f}; against the real-clip bands {bands}: "
          f"{'PASS' if verdict['ok'] else 'FAIL'} {verdict} (a reading, not a gate). The JAX "
          f"package's report (logs/bbc_r5/gait_report_28k.txt: another checkpoint, 8 envs, 300 "
          f"steps on a CPU; not comparable): " + " | ".join(jax_trot), flush=True)
    physical = (np.isfinite(duty).all() and np.isfinite(hz).all() and np.isfinite(sync)
                and ((0 <= duty) & (duty <= 1)).all() and 0 <= sync <= 1
                and ((0 <= hz) & (hz <= 1 / (2 * dt))).all())
    if not physical:
        raise SystemExit("BBC slice: a gait statistic is not finite or outside its physical "
                         "range")


def link_teacher(root):
    """<root>/agility/r5/model_12000.msgpack, a link to the TSC teacher (so
    that nothing is written under logs/); returns the link."""
    run = os.path.join(root, "agility", "r5")
    os.makedirs(run, exist_ok=True)
    link = os.path.join(run, os.path.basename(TSC_CHECKPOINT))
    if not os.path.lexists(link):
        os.symlink(TSC_CHECKPOINT, link)
    return link


def phase_tsc_slice(num_envs, steps, root):
    from agility_tpu_torch.cli import play_tsc
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.physics import heightfield as hf

    link = link_teacher(root)
    args = play_tsc.get_args(["--device", "cuda", "--num_envs", str(num_envs), "--courses",
                              "64", "--steps", str(steps), "--log_root", root, "--proj_name",
                              "agility", "--exptid", "r5", "--bbc_path", TSC_BBC])
    _counts_zero()
    res = play_tsc.run(args)
    launches = _counts()
    resolved = ckpt.latest(play_tsc.run_dir(args))
    want_sd = ckpt.params_from_jax_tsc(ckpt.read_msgpack(TSC_CHECKPOINT))
    by_name = resolved == link and all(
        torch.equal(v.cpu(), want_sd[name][k]) for name, mod in (
            ("actor_critic", res["policy"].ac), ("estimator", res["policy"].est))
        for k, v in mod.state_dict().items())
    print(f"TSC slice: teacher resolved through --log_root/--proj_name/--exptid to {resolved}, "
          f"weights equal {os.path.basename(TSC_CHECKPOINT)}'s {by_name}", flush=True)
    if not by_name:
        raise SystemExit("TSC slice: the teacher resolved by name is not model_12000")
    env, s = res["env"], res["state"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*s.sim, s.obs_buf, s.obs_bbc_buf, s.seesaw_theta))
    pos = s.sim.base_pos
    floor = hf.sample_height(env.grid, pos[:, 0], pos[:, 1], env._weights(s))
    med_h = float((pos[:, 2] - floor).median())
    want = dict(contact_lcp=env.engine_cfg.decimation * res["steps"],
                terrain_window=res["steps"], scandots=res["steps"])
    print(f"TSC slice: {num_envs} envs x 64 courses x {steps} control steps, launches "
          f"{launches} (want {want}), all states finite {finite}, median base height over "
          f"the folded floor {med_h:.4f} m; episodes {res['episodes']}, course completions "
          f"{res['completions']}, mean goal index "
          f"{float(s.cur_goal_idx.float().mean()):.3f}, {res['env_steps_per_s']:.1f} "
          f"env-steps/s on {torch.cuda.get_device_name(0)}", flush=True)
    if launches != want:
        raise SystemExit("TSC slice: a kernel's launch count differs from the steps run")
    if not finite:
        raise SystemExit("TSC slice: non-finite state")
    if not 0.15 <= med_h <= 0.45:
        raise SystemExit("TSC slice: median base height over the floor outside [0.15, 0.45] m")
    tsc_busy_share(res, num_envs)
    return launches


def tsc_busy_share(res, num_envs, steps=2):
    """step_profile of a play_tsc rollout's policy step."""
    env, policy = res["env"], res["policy"]
    step_profile("TSC", lambda s: policy.step(env, s)[0], res["state"],
                 num_envs / res["env_steps_per_s"] * 1e3, steps)


def _rel(a, b):
    """|a - b| / max(|b|, 1e-3), two-norms, b on the CPU."""
    a = a.detach().float().cpu().reshape(-1)
    b = b.detach().float().reshape(-1)
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-3))


def _stage_errors(gm, cm, gts, cts, nets):
    """The largest metric error of a train stage and the parameter error of
    each network in `nets` (those the stage updates), card (g) vs CPU (c)."""
    m = max(_rel(gm[k], cm[k]) for k in cm)
    p = {k: _rel(torch.cat([t.flatten() for t in getattr(gts, k).parameters()]),
                 torch.cat([t.flatten() for t in getattr(cts, k).parameters()]))
         for k in nets}
    return m, p


def phase_train_parity(num_envs=64, steps=8):
    """One BBC train iteration on the card (kernels) against the CPU (plain
    versions): the rollout from one state, then each update stage on
    identical inputs."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_locomotion import Go2LocomotionEnv
    from agility_tpu_torch.learn.ssinfogail import AlgoCfg, Draws, SSInfoGAIL, Transition

    cfg = registry.apply_overrides(registry.get("go2_locomotion")[0](),
                                   **{"env.num_envs": num_envs, "noise.add_noise": False,
                                      "domain_rand.push_robots": False})
    acfg = AlgoCfg(num_steps_per_env=steps, num_preload_transitions=20_000,
                   disc_replay_buffer_size=4 * steps * num_envs)
    ga = SSInfoGAIL(Go2LocomotionEnv(cfg, "cuda", seed=0), acfg, seed=0)
    ca = SSInfoGAIL(Go2LocomotionEnv(cfg, "cpu", seed=0), acfg, seed=0)
    ca.expert_lb, ca.expert_labels, ca.expert_ulb = (
        t.cpu() for t in (ga.expert_lb, ga.expert_labels, ga.expert_ulb))
    gts, cts = ga.init_train_state(), ca.init_train_state()
    for k in ("ac", "est", "disc"):
        getattr(cts, k).load_state_dict(getattr(gts, k).state_dict())
    es = ga.env.init_state()
    es = es._replace(prior_parameters=gts.prior_parameters)
    dh = es.disc_obs[:, None].repeat(1, ga.disc_obs_len, 1)
    draws = ca.draw(cts)
    gdraws = Draws(*(d.cuda() for d in draws))
    cuda = lambda t: Transition(*(x.cuda() for x in t))

    # the rollout (it = 0: through the DAgger latent)
    ges, _, g_rollout, _ = ga.rollout(gts, es, dh, True, gdraws.action_noise)
    ces, _, ctrs, _ = ca.rollout(cts, _to(es, "cpu"), dh.cpu(), True, draws.action_noise)
    reset_g, reset_c = g_rollout.dones.any(0).cpu(), ctrs.dones.any(0)
    keep = ~(reset_g | reset_c)
    errs = {k: float((getattr(ges.sim, k).cpu() - getattr(ces.sim, k))[keep].abs().max())
            for k in SOA_TOL}
    print(f"train parity {num_envs} envs x {steps} steps, rollout card vs CPU: "
          f"{int((~keep).sum())} envs reset; "
          + ", ".join(f"{k} {v:.3e} (tol {SOA_TOL[k]:g})" for k, v in errs.items()), flush=True)
    # what the rollout stored, the card's disc reward and ring insert included
    ring_rows = lambda ts: ts.ring.data[:steps * num_envs].reshape(steps, num_envs, -1)
    stored = {k: (getattr(g_rollout, k), getattr(ctrs, k))
              for k in ("rewards", "values", "log_prob", "mean")}
    stored["ring rows"] = (ring_rows(gts), ring_rows(cts))
    rerr = {k: _rel(g.cpu()[:, keep], c[:, keep]) for k, (g, c) in stored.items()}
    print("train parity, the rollout's transitions and ring rows card vs CPU (relative, tol "
          f"{ROLLOUT_TOL:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in rerr.items()), flush=True)
    if not torch.equal(reset_g, reset_c):
        raise SystemExit("train parity: the card and the CPU reset different envs")
    if not all(np.isfinite(v) and v <= SOA_TOL[k] for k, v in errs.items()):
        raise SystemExit("train parity: the card's rollout disagrees with the CPU's")
    if not all(np.isfinite(v) and v <= ROLLOUT_TOL for v in rerr.values()):
        raise SystemExit("train parity: the card's rollout stored other transitions or rows")

    # the stages on identical inputs: the CPU rollout and ring on both sides
    gts.ring.load_state_dict(cts.ring.state_dict())
    with torch.no_grad():
        clast = cts.ac.value(ces.obs_buf)
        glast = gts.ac.value(ces.obs_buf.cuda())
    cadv, cret = ca.compute_gae(ctrs, clast)
    gadv, gret = ga.compute_gae(cuda(ctrs), glast)
    gae = max(_rel(gadv, cadv), _rel(gret, cret))
    gtrs = cuda(ctrs)
    stages = {}
    gm = ga.ppo_update(gts, gtrs, cadv.cuda(), cret.cuda(), gdraws.ppo_perm)
    cm = ca.ppo_update(cts, ctrs, cadv, cret, draws.ppo_perm)
    stages["ppo"] = _stage_errors(gm, cm, gts, cts, ("ac", "est"))
    gm, cm = ga.disc_update(gts, gdraws.disc_idx), ca.disc_update(cts, draws.disc_idx)
    stages["disc"] = _stage_errors(gm, cm, gts, cts, ("disc",))
    gm = ga.dagger_update(gts, gtrs, gdraws.dagger_perm)
    cm = ca.dagger_update(cts, ctrs, draws.dagger_perm)
    stages["dagger"] = _stage_errors(gm, cm, gts, cts, ("ac",))
    print(f"train parity, stages on identical inputs, card vs CPU (tol {TRAIN_TOL:g}; disc "
          f"params {DISC_PARAM_TOL:g}): gae {gae:.3e}; "
          + "; ".join(f"{k} metrics {m:.3e}, params "
                      + ", ".join(f"{n} {v:.3e}" for n, v in p.items())
                      for k, (m, p) in stages.items()), flush=True)
    bad = gae > TRAIN_TOL or not np.isfinite(gae)
    for k, (m, p) in stages.items():
        ptol = DISC_PARAM_TOL if k == "disc" else TRAIN_TOL
        bad |= not (m <= TRAIN_TOL and all(v <= ptol for v in p.values()))
    if bad:
        raise SystemExit("train parity: a train stage on the card disagrees with the CPU's")


def phase_tsc_train_parity(num_envs=64, courses=8, steps=8):
    """One TSC teacher train iteration on the card (kernels) against the CPU
    (plain versions): the rollout from one state, then each update stage on
    identical inputs."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.ppo_tsc import TscAlgoCfg, TscDraws, TscPPO, TscTransition

    cfg = registry.apply_overrides(registry.get("go2")[0](), **{
        "env.num_envs": num_envs, "obstacle.courses": courses, "env.randomize_start": True,
        "domain_rand.randomize_base_mass": True, "domain_rand.randomize_base_com": True,
        "domain_rand.randomize_action": False})
    acfg = TscAlgoCfg(num_steps_per_env=steps)
    bbc = ckpt.load_bbc_frozen(TSC_BBC)
    ga = TscPPO(Go2AgilityEnv(cfg, "cuda", seed=0), bbc, acfg, seed=0)
    ca = TscPPO(Go2AgilityEnv(cfg, "cpu", seed=0), bbc, acfg, seed=0)
    gts, cts = ga.init_train_state(), ca.init_train_state()
    for k in ("ac", "est"):
        getattr(cts, k).load_state_dict(getattr(gts, k).state_dict())
    es = ga.env.init_state()
    dh = es.disc_obs[:, None].repeat(1, cfg.env.disc_obs_len, 1)
    draws = ca.draw()
    gdraws = TscDraws(*(d.cuda() for d in draws))
    cuda = lambda t: TscTransition(*(x.cuda() for x in t))

    # the rollout (it = 0: through the DAgger latent)
    ges, _, groll, _ = ga.rollout(gts, es, dh, True, gdraws.gumbel, gdraws.normal)
    ces, _, ctrs, _ = ca.rollout(cts, _to(es, "cpu"), dh.cpu(), True, draws.gumbel,
                                 draws.normal)
    reset_g, reset_c = groll.dones.any(0).cpu(), ctrs.dones.any(0)
    keep = ~(reset_g | reset_c)
    errs = {k: float((getattr(ges.sim, k).cpu() - getattr(ces.sim, k))[keep].abs().max())
            for k in SOA_TOL}
    modes = torch.equal(groll.actions[..., 0].cpu()[:, keep], ctrs.actions[..., 0][:, keep])
    print(f"TSC train parity {num_envs} envs x {courses} courses x {steps} steps, rollout card "
          f"vs CPU: {int((~keep).sum())} envs reset; modes equal {modes}; "
          + ", ".join(f"{k} {v:.3e} (tol {SOA_TOL[k]:g})" for k, v in errs.items()), flush=True)
    rerr = {k: _rel(getattr(groll, k).cpu()[:, keep], getattr(ctrs, k)[:, keep])
            for k in ("rewards", "values", "logp_d", "logp_c", "mean")}
    print("TSC train parity, the rollout's transitions card vs CPU (relative, tol "
          f"{ROLLOUT_TOL:g}): " + ", ".join(f"{k} {v:.3e}" for k, v in rerr.items()), flush=True)
    if not torch.equal(reset_g, reset_c):
        raise SystemExit("TSC train parity: the card and the CPU reset different envs")
    if not (modes and all(np.isfinite(v) and v <= SOA_TOL[k] for k, v in errs.items())):
        raise SystemExit("TSC train parity: the card's rollout disagrees with the CPU's")
    if not all(np.isfinite(v) and v <= ROLLOUT_TOL for v in rerr.values()):
        raise SystemExit("TSC train parity: the card's rollout stored other transitions")

    # the stages on identical inputs: the CPU rollout on both sides
    with torch.no_grad():
        clast = cts.ac.value(ces.obs_buf)
        glast = gts.ac.value(ces.obs_buf.cuda())
    cadv, cret = ca.compute_gae(ctrs, clast)
    gadv, gret = ga.compute_gae(cuda(ctrs), glast)
    gae = max(_rel(gadv, cadv), _rel(gret, cret))
    gtrs = cuda(ctrs)
    stages = {}
    gm = ga.ppo_update(gts, gtrs, cadv.cuda(), cret.cuda(), gdraws.ppo_perm)
    cm = ca.ppo_update(cts, ctrs, cadv, cret, draws.ppo_perm)
    stages["ppo"] = _stage_errors(gm, cm, gts, cts, ("ac", "est"))
    gm = {"dagger": ga.dagger_update(gts, gtrs, gdraws.dagger_perm)}
    cm = {"dagger": ca.dagger_update(cts, ctrs, draws.dagger_perm)}
    stages["dagger"] = _stage_errors(gm, cm, gts, cts, ("ac",))
    print(f"TSC train parity, stages on identical inputs, card vs CPU (tol {TRAIN_TOL:g}): "
          f"gae {gae:.3e}; lr {float(gts.lr):.3g} / {float(cts.lr):.3g}; "
          + "; ".join(f"{k} metrics {m:.3e}, params "
                      + ", ".join(f"{n} {v:.3e}" for n, v in p.items())
                      for k, (m, p) in stages.items()), flush=True)
    bad = gae > TRAIN_TOL or not np.isfinite(gae) or gts.lr != cts.lr
    for m, p in stages.values():
        bad |= not (m <= TRAIN_TOL and all(v <= TRAIN_TOL for v in p.values()))
    if bad:
        raise SystemExit("TSC train parity: a train stage on the card disagrees with the CPU's")


def timed_training(label, cli, argv, num_envs, probe_steps=4):
    """Build a runner through `cli`'s build (timed), time the env step alone
    (`probe_steps` steps; 0 skips it), train through `cli`'s train with a
    CUDA event at every stage mark and the host clock, synchronised, at
    each iteration's start (before its draws) and end (after the runner's
    log line, events and saves), then time the env step again.  Counts the
    kernels' launches and the collectives (dist/mesh.py's all-reduces, each
    timed by CUDA events) in training.  Prints each iteration's stages and
    the rate over iterations 1 to the last (iteration 0, with DAgger, where
    it is the only one); returns a dict: runner, launches, it_ms (mean
    iteration ms over those), its (stage ms per iteration), wall_ms (each
    iteration's host time), metrics (each iteration's), peak (bytes),
    rate, build_s, collectives (calls) and collective_ms."""
    from agility_tpu_torch.dist import mesh
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    args = cli.get_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = cli.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    marks, host, metrics = [], {"start": [], "end": []}, []

    def mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))
        if stage in host:
            torch.cuda.synchronize()
            host[stage].append(time.perf_counter())
        if stage == "end":
            metrics.append(metrics_to_host(runner.last_metrics))

    step_before = env_step_ms(runner, probe_steps) if probe_steps else float("nan")
    runner.alg.timer = mark
    _counts_zero()
    mesh.all_reduce_.calls, mesh.all_reduce_.events = 0, []
    t0 = time.perf_counter()
    try:
        cli.train(runner, args)
        torch.cuda.synchronize()
    finally:
        n_coll, coll = mesh.all_reduce_.calls, mesh.all_reduce_.events
        mesh.all_reduce_.events = None
    wall = time.perf_counter() - t0
    launches = _counts()
    coll_ms = sum(a.elapsed_time(b) for a, b in coll)
    runner.alg.timer = None
    peak = torch.cuda.max_memory_allocated()
    step_after = env_step_ms(runner, probe_steps) if probe_steps else float("nan")

    # per iteration: each stage's time from the events (from the mark
    # before it, summed over a stage's marks; "end" is the runner's work
    # after the updates), and the iteration's time on the host clock
    its, prev = [], None
    for stage, ev in marks:
        if stage == "start":
            its.append({})
        else:
            its[-1][stage] = its[-1].get(stage, 0.0) + prev.elapsed_time(ev)
        prev = ev
    wall_ms = [(b - a) * 1e3 for a, b in zip(host["start"], host["end"])]
    T = runner.cfg.num_steps_per_env
    # all the work from iteration 1's start to the last one's end
    first = 1 if len(wall_ms) >= 2 else 0
    rate = ((len(wall_ms) - first) * T * num_envs / (host["end"][-1] - host["start"][first]))
    it_ms = float(np.mean(wall_ms[first:]))
    for i, (ms, it) in enumerate(zip(wall_ms, its)):
        print(f"{label} iteration {i}: {ms:.1f} ms on the host clock, {sum(it.values()):.1f} "
              "ms of events; stages (ms) " + ", ".join(f"{k} {v:.1f}" for k, v in it.items()),
              flush=True)
    print(f"{label}: {num_envs} envs x {T} steps x {len(wall_ms)} iterations in {wall:.1f} s "
          f"(build {t_build:.1f} s); {rate:.1f} env-steps/s over iterations "
          f"{first}-{len(wall_ms) - 1} (host clock, synchronised, start to end); launches "
          f"{launches}; collectives {n_coll} all-reduces, {coll_ms:.1f} ms of events "
          f"({100 * coll_ms / sum(wall_ms):.2f}% of the iterations' host time); peak device "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated) on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if probe_steps:
        step_stage = "env" if "env" in its[0] else "rollout"
        print(f"{label}: the env step alone (zero actions, no trainer) {step_before:.1f} ms "
              f"before training, {step_after:.1f} ms after; the rollout's {step_stage} stage a "
              "step " + ", ".join(f"{it[step_stage] / T:.1f}" for it in its) + " ms", flush=True)
    return dict(runner=runner, launches=launches, it_ms=it_ms, its=its, wall_ms=wall_ms,
                metrics=metrics, peak=peak, rate=rate, build_s=t_build, collectives=n_coll,
                collective_ms=coll_ms)


def _log_root():
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix="train_smoke-", dir=os.path.join(ROOT, "build"))


def phase_train(num_envs, iters):
    """cli/train_bbc at full width for `iters` iterations; returns the
    kernels' launches."""
    from agility_tpu_torch.cli import train_bbc
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.policy import build_policy
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    root = _log_root()
    try:
        res = timed_training(
            "BBC train", train_bbc,
            ["--task", "go2_locomotion", "--num_envs", str(num_envs), "--max_iterations",
             str(iters), "--device", "cuda", "--log_root", root, "--log_every", "1"], num_envs)
        runner, launches, it_ms = res["runner"], res["launches"], res["it_ms"]
        T = runner.cfg.num_steps_per_env
        m = metrics_to_host(runner.last_metrics)
        ts = runner.train_state
        finite = all(bool(torch.isfinite(p).all()) for k in ("ac", "est", "disc")
                     for p in getattr(ts, k).parameters()) and all(map(np.isfinite, m.values()))
        print(f"BBC train: ring size {ts.ring.size}; normaliser count "
              f"{float(ts.disc_norm.count):.1f}; metrics {json.dumps(m)}", flush=True)

        path = ckpt.latest(runner.log_dir)
        policy = build_policy(runner.env.cfg, ckpt.params_from_jax(ckpt.read_msgpack(path)),
                              "cuda")
        same = all(torch.equal(a, b) for mine, back in ((ts.ac, policy.ac), (ts.est, policy.est))
                   for a, b in zip(mine.state_dict().values(), back.state_dict().values()))
        print(f"BBC train: slim checkpoint {os.path.basename(path)} read back by play_bbc's "
              f"loader, tensors equal {same}", flush=True)
        want = dict(contact_lcp=runner.env.engine_cfg.decimation * T * iters,
                    terrain_window=T * iters, scandots=0)
        if launches != want:
            raise SystemExit(f"BBC train: launches {launches}, want {want}")
        if not finite:
            raise SystemExit("BBC train: a parameter or metric is not finite")
        if ts.ring.size != iters * T * num_envs:
            raise SystemExit("BBC train: the ring holds the wrong number of rows")
        if not float(ts.disc_norm.count) > 1e-4:
            raise SystemExit("BBC train: the normaliser was never updated")
        if not same:
            raise SystemExit("BBC train: the slim checkpoint does not read back equal")
        train_busy_share("BBC train", teacher_iteration(runner), it_ms)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_bbc_mocap(num_envs, root):
    """Clip files in the reference's layout under `root`, load_dir on the
    card against the CPU, then cli/train_bbc --mocap_dir at full width for
    one iteration; returns the kernels' launches in training."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import write_clip_dir

    from agility_tpu_torch.cli import train_bbc
    from agility_tpu_torch.envs import mocap
    from agility_tpu_torch.envs.config import MOCAP_CATEGORIES
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.policy import build_policy
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    clips = os.path.join(root, "mocap")
    t0 = time.perf_counter()
    written = write_clip_dir(clips)
    t_write = time.perf_counter() - t0
    dirs = (os.path.join(clips, "mocap_all_lb"), os.path.join(clips, "mocap_all_ulb"))
    card, host = (mocap.load_dir(*dirs, MOCAP_CATEGORIES, d) for d in ("cuda", "cpu"))
    same = card.ulb_dur == host.ulb_dur and all(
        torch.equal(getattr(card, k).cpu(), v) for k, v in host._asdict().items()
        if isinstance(v, torch.Tensor))
    lb = [n for _, n in written["lb"]]
    n_ulb = sum(n for _, n in written["ulb"])
    print(f"BBC mocap: {len(lb)} labelled clips of {lb} frames at frame durations "
          f"{sorted(set(host.clip_dur.tolist()))} s and {len(written['ulb'])} unlabelled files of "
          f"{n_ulb} frames (ulb_dur {host.ulb_dur:.4f} s) written in {t_write:.2f} s; load_dir "
          f"on the card bit-equal to the CPU's {same}", flush=True)
    if not same:
        raise SystemExit("BBC mocap: load_dir on the card differs from the CPU's")

    args = train_bbc.get_args(["--task", "go2_locomotion", "--num_envs", str(num_envs),
                               "--max_iterations", "1", "--device", "cuda", "--log_root",
                               os.path.join(root, "runs"), "--log_every", "1", "--mocap_dir",
                               clips])
    t0 = time.perf_counter()
    runner = train_bbc.build(args)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    _counts_zero()
    t0 = time.perf_counter()
    train_bbc.train(runner, args)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = _counts()
    alg, ts, m = runner.alg, runner.train_state, runner.env.motion
    # the preload again, alone: both expert tables from the loaded clips
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg._preload(True)
    alg._preload(False)
    torch.cuda.synchronize()
    t_preload = time.perf_counter() - t0
    counts = m.clip_frames.tolist() == lb and m.ulb_frames.shape[0] == n_ulb
    modes = torch.bincount(alg.expert_labels, minlength=len(MOCAP_CATEGORIES)).tolist()
    metrics = metrics_to_host(runner.last_metrics)
    finite = all(bool(torch.isfinite(p).all()) for k in ("ac", "est", "disc")
                 for p in getattr(ts, k).parameters()) and all(map(np.isfinite, metrics.values()))
    path = ckpt.latest(runner.log_dir)
    policy = build_policy(runner.env.cfg, ckpt.params_from_jax(ckpt.read_msgpack(path)), "cuda")
    back = all(torch.equal(a, b) for mine, got in ((ts.ac, policy.ac), (ts.est, policy.est))
               for a, b in zip(mine.state_dict().values(), got.state_dict().values()))
    T = runner.cfg.num_steps_per_env
    print(f"BBC mocap: train_bbc --mocap_dir, {num_envs} envs x {T} steps x 1 iteration: build "
          f"(env, clips, trainer, preload) {t_build:.2f} s, the iteration (DAgger, save "
          f"included) {t_iter:.2f} s, {T * num_envs / t_iter:.1f} env-steps/s; the preload "
          f"alone ({alg.cfg.num_preload_transitions} labelled + as many unlabelled transitions) "
          f"{t_preload:.3f} s; launches {launches}; motion tables' clip and frame counts equal "
          f"the files' {counts}; expert labels per mode {modes}; metrics {json.dumps(metrics)}; "
          f"checkpoint {os.path.basename(path)} read back equal {back}; on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    want = dict(contact_lcp=runner.env.engine_cfg.decimation * T, terrain_window=T, scandots=0)
    if launches != want:
        raise SystemExit(f"BBC mocap: launches {launches}, want {want}")
    if not (finite and counts and min(modes) > 0 and back):
        raise SystemExit("BBC mocap: non-finite parameters or metrics, tables unlike the "
                         "files, a mode missing from the expert labels, or the checkpoint "
                         "not read back equal")
    return launches


def _keystr_leaves(tree, prefix=""):
    """(jax.tree_util.keystr path, array) of a nested dict's leaves, keys sorted."""
    for k in sorted(tree):
        path = f"{prefix}[{k!r}]"
        if isinstance(tree[k], dict):
            yield from _keystr_leaves(tree[k], path)
        else:
            yield path, np.asarray(tree[k])


def phase_export(root, bbc):
    """io/export on the BBC inference policy (bbc_final) at the BBC path's
    width, on `bbc`'s (env, ...) initial observations: the exported program
    loaded back against the eager policy, and the parameter dump against
    params_to_jax's tree."""
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.io import export
    from agility_tpu_torch.learn.policy import build_policy

    env = bbc[0]
    sd = ckpt.params_from_jax(ckpt.read_msgpack(TSC_BBC))
    policy = build_policy(env.cfg, sd, "cuda")
    obs = env.init_state().obs_buf
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = export.export_policy(policy, (obs,), os.path.join(root, "bbc_final"))
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = export.load_policy(path)
    t_load = time.perf_counter() - t0
    got, want = loaded(obs), policy(obs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tree = ckpt.params_to_jax(policy.ac.state_dict(), policy.est.state_dict(),
                              sd["discriminator"])
    npz = np.load(export.export_params_npz(tree, os.path.join(root, "bbc_final")))
    leaves = dict(_keystr_leaves(tree))
    keys = list(npz.files) == list(leaves) and all(np.array_equal(npz[k], v)
                                                  for k, v in leaves.items())
    print(f"export: bbc_final's inference policy at {tuple(obs.shape)} obs on the card, "
          f"torch.export {t_export:.2f} s to {os.path.basename(path)} "
          f"({os.path.getsize(path)} bytes), load {t_load:.2f} s; loaded vs eager actions max abs "
          f"err {err:.3e} (tol 1e-6), finite {bool(torch.isfinite(got).all())}; params npz "
          f"{len(npz.files)} keys equal params_to_jax's tree key for key {keys}", flush=True)
    if not (err <= 1e-6 and bool(torch.isfinite(got).all()) and got.shape == want.shape):
        raise SystemExit("export: the loaded program's actions differ from the eager policy's")
    if not keys:
        raise SystemExit("export: the params npz differs from params_to_jax's tree")


def phase_tsc_train(num_envs, iters):
    """cli/train_tsc at full width (64 courses, the reference's teacher
    flags, the frozen bbc_final) for `iters` iterations; returns the
    kernels' launches."""
    from agility_tpu_torch.cli import train_tsc
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    root = _log_root()
    try:
        res = timed_training(
            "TSC train", train_tsc,
            ["--num_envs", str(num_envs), "--courses", "64", "--bbc_path", TSC_BBC,
             "--randomize_start", "--randomize_base_mass", "--randomize_base_com",
             "--push_robots", "--max_iterations", str(iters), "--device", "cuda",
             "--log_root", root, "--log_every", "1"], num_envs)
        runner, launches, it_ms = res["runner"], res["launches"], res["it_ms"]
        T = runner.cfg.num_steps_per_env
        m = metrics_to_host(runner.last_metrics)
        ts = runner.train_state
        finite = all(bool(torch.isfinite(p).all()) for k in ("ac", "est")
                     for p in getattr(ts, k).parameters()) and all(map(np.isfinite, m.values()))
        std_min = float(ts.ac.std.detach().min())
        print(f"TSC train: priv_reg_counter {ts.priv_reg_counter}, lr {float(ts.lr):.3g}, "
              f"std min {std_min:.4f}; success rate {float(runner.env_state.success_rate):.4f}; "
              f"metrics {json.dumps(m)}", flush=True)

        path = ckpt.latest(runner.log_dir)
        back = ckpt.params_from_jax_tsc(ckpt.read_msgpack(path))
        same = all(torch.equal(v.cpu(), back[name][k]) for name, mod in (
            ("actor_critic", ts.ac), ("estimator", ts.est)) for k, v in mod.state_dict().items())
        print(f"TSC train: slim checkpoint {os.path.basename(path)} read back by "
              f"params_from_jax_tsc, tensors equal {same}", flush=True)
        want = dict(contact_lcp=runner.env.engine_cfg.decimation * T * iters,
                    terrain_window=T * iters, scandots=T * iters)
        if launches != want:
            raise SystemExit(f"TSC train: launches {launches}, want {want}")
        if not finite:
            raise SystemExit("TSC train: a parameter or metric is not finite")
        if ts.priv_reg_counter != iters + 1:
            raise SystemExit(f"TSC train: priv_reg_counter {ts.priv_reg_counter}, want {iters + 1}"
                             " (one PPO update an iteration, DAgger at iteration 0)")
        if not std_min >= np.float32(runner.cfg.min_std):
            raise SystemExit("TSC train: the continuous head's std fell below min_std")
        if not same:
            raise SystemExit("TSC train: the slim checkpoint does not read back equal")
        train_busy_share("TSC train", teacher_iteration(runner), it_ms)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ddp_ranks(bbc_cfg, tsc_cfg, algo_kw, bbc_path, inputs=None):
    """The DDP parity phase's work on cuda:0 (tests/torch_dist_cases.py), on
    this process's envs: a BBC env step, two TSC env steps, a BBC train
    iteration and a TSC teacher iteration (under the frozen BBC of
    `bbc_path`) with the "full" trainer kwargs, and for each {name: (BBC
    kwargs, TSC kwargs)} of `algo_kw` both trainers' update stages on one
    rollout: the one made here when `inputs` is None (returned as the
    second value), else the rollouts in `inputs`."""
    import torch_dist_cases as cases

    full_b, full_t = algo_kw["full"]
    out = dict(bbc_step=cases.bbc_env_step("cuda", bbc_cfg),
               tsc_steps=cases.tsc_env_steps(2, "cuda", tsc_cfg),
               bbc=cases.bbc_iteration("cuda", 0, bbc_cfg, full_b),
               tsc=cases.tsc_iteration("cuda", 0, tsc_cfg, full_t, bbc_path))
    made = {}
    for name, (bkw, tkw) in algo_kw.items():
        for net, cfg, kw in (("bbc", bbc_cfg, bkw), ("tsc", tsc_cfg, tkw)):
            key = f"{net} {name}"
            out[key], made[key] = cases.stages("cuda", cfg, kw, bbc_path,
                                               None if inputs is None else inputs[key])
    return out, (made if inputs is None else None)


def _param_excess(got, want):
    """(max |got - want|, max of |got - want| - (atol + rtol |want|)) of two
    flat parameter vectors, DDP_TOL's rtol and atol."""
    d = (got - want).abs()
    return float(d.max()), float((d - DDP_TOL["atol"] - DDP_TOL["rtol"] * want.abs()).max())


def phase_ddp_parity(num_envs=DDP_ENVS, courses=8, steps=8):
    """dist/mesh.py on the card: two gloo ranks on cuda:0 (NCCL refuses two
    ranks on one device), spawned by mesh.launch, each run on their half of
    the envs what ddp_ranks runs; the same in this process without a group
    is the 1-rank run.  The configs: the rough go2_locomotion config at
    `num_envs` global envs (T = `steps`, observation noise and pushes on),
    and the go2 config at `num_envs` x `courses` (the teacher flags, the
    curriculum on; the TSC env steps start with a quarter of the envs
    finishing their course and the curriculum due), the frozen bbc_final;
    trainer sizes "full" (train parity's AlgoCfg / TscAlgoCfg: 5 epochs x 4
    minibatches, the BBC's 80 disc minibatches) and "test_dist"
    (tests/test_dist.py's 1 epoch x 2 minibatches).  Gates,
    tests/test_dist.py's (DDP_TOL): the env steps' obs, rewards and base
    positions within 1e-5 and the TSC success EMAs and curriculum count
    equal; the full iterations' rollout/r_total within 1e-4 relative and
    K1 and K2 (and K3 on the TSC) launched in each rank; the update stages
    on the 1-rank run's rollout at the test_dist size (GAE's advantages
    within 1e-5, then every network's parameters after PPO, the disc
    update and DAgger within 1e-3 relative + 1e-4); the ranks' parameters
    bit-identical everywhere.  Printed as readings: the full iterations'
    parameters and end states (there the two runs' rollouts differ
    already: a matrix product rounds differently at another batch size,
    and a discrete mode or a contact flips on it) and the full-size
    stages' parameters (20 Adam steps a minibatch pass move a parameter
    whose gradient is near zero by up to the learning rate a step, so the
    rounding of a sum split in two can reach 2e-4 after TSC DAgger's 20)."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.dist import mesh

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    bcfg = registry.apply_overrides(registry.get("go2_locomotion")[0](),
                                    **{"env.num_envs": num_envs})
    bkw = dict(num_steps_per_env=steps, num_preload_transitions=20_000,
               disc_replay_buffer_size=4 * steps * num_envs)
    small = dict(num_learning_epochs=1, num_mini_batches=2)
    algo_kw = {"full": (bkw, dict(num_steps_per_env=steps)),
               "test_dist": ({**bkw, **small}, dict(num_steps_per_env=steps, **small))}
    tcfg = registry.apply_overrides(registry.get("go2")[0](), **{
        "env.num_envs": num_envs, "obstacle.courses": courses, "env.randomize_start": True,
        "domain_rand.randomize_base_mass": True, "domain_rand.randomize_base_com": True,
        "obstacle.curriculum": True})
    t0 = time.perf_counter()
    one, inputs = ddp_ranks(bcfg, tcfg, algo_kw, TSC_BBC)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = [r[0] for r in mesh.launch(ddp_ranks, 2, args=(bcfg, tcfg, algo_kw, TSC_BBC, inputs),
                                     backend="gloo", device="cuda", timeout_s=600.0)]
    t_two = time.perf_counter() - t0
    bad = []
    cat = lambda parts, k, dim=0: torch.cat([q[k] for q in parts], dim)

    steps_out = [("BBC step 0", one["bbc_step"], [q["bbc_step"] for q in two])]
    steps_out += [(f"TSC step {t}", one["tsc_steps"][t], [q["tsc_steps"][t] for q in two])
                  for t in range(len(one["tsc_steps"]))]
    for label, ref, parts in steps_out:
        err = {k: float((cat(parts, k) - ref[k]).abs().max()) for k in ("obs", "rew", "base_pos")}
        line = f"DDP parity {label}: 2 ranks vs one process, max abs " + ", ".join(
            f"{k} {v:.3e}" for k, v in err.items()) + f" (tol {DDP_TOL['state']:g})"
        if "success_rate" in ref:
            emas = [tuple(q[k] for k in ("success_rate", "success_rate_s0", "goal_progress",
                                         "curr_count")) for q in (*parts, ref)]
            line += (f"; resets {int(ref['reset'].sum())}, success EMAs, goal progress and "
                     f"curriculum count (rank 0, rank 1, one process) {emas}")
            if len(set(emas)) != 1:
                bad.append(f"{label}: the success EMAs or the curriculum count differ")
        print(line, flush=True)
        if not all(v <= DDP_TOL["state"] for v in err.values()):
            bad.append(f"{label}: 2 ranks disagree with one process")

    for label, kernels in (("bbc", ("contact_lcp", "terrain_window")),
                           ("tsc", ("contact_lcp", "terrain_window", "scandots"))):
        ref, parts = one[label], [q[label] for q in two]
        same = all(torch.equal(parts[0]["groups"][k], parts[1]["groups"][k])
                   for k in ref["groups"])
        perr = {k: _param_excess(parts[0]["groups"][k], w) for k, w in ref["groups"].items()}
        r_a, r_b = parts[0]["metrics"]["rollout/r_total"], ref["metrics"]["rollout/r_total"]
        r_err = abs(r_a - r_b) / max(abs(r_b), 1e-30)
        s_err = {k: float((cat([q["sim"] for q in parts], k) - ref["sim"][k]).abs().max())
                 for k in ("base_pos", "base_quat", "dof_pos", "u")}
        launched = [q["launches"] for q in parts]
        emas = ([(q["success_rate"], q["curr_count"]) for q in (*parts, ref)]
                if label == "tsc" else [])
        print(f"DDP parity {label} iteration (full): {num_envs} envs x {steps} steps, the "
              f"ranks' parameters bit-identical {same}; vs one process: rollout/r_total "
              f"{r_a:.7g} vs {r_b:.7g}, rel {r_err:.3e} (tol {DDP_TOL['r_total']:g}); readings: "
              "parameters max abs diff (excess over 1e-4 + 1e-3 |p|) "
              + ", ".join(f"{k} {m:.3e} ({e:.3e})" for k, (m, e) in perr.items())
              + "; end states after the rollout max abs "
              + ", ".join(f"{k} {v:.3e}" for k, v in s_err.items())
              + f"; launches per rank {launched}" + (f"; success EMA, curriculum count {emas}"
                                                     if emas else ""), flush=True)
        if len(set(emas)) > 1:
            bad.append(f"{label} iteration: success EMA or curriculum count differ")
        if not same:
            bad.append(f"{label} iteration: the ranks' parameters differ")
        if r_err > DDP_TOL["r_total"]:
            bad.append(f"{label} iteration: rollout/r_total of 2 ranks differs from one process's")
        if not all(q[k] > 0 for q in launched for k in kernels):
            bad.append(f"{label} iteration: a rank launched no {kernels}")

    for key in (f"{net} {name}" for name in algo_kw for net in ("bbc", "tsc")):
        ref, parts = one[key], [q[key] for q in two]
        adv = float((cat(parts, "adv", 1) - ref["adv"]).abs().max())
        gated = key.endswith("test_dist")
        cells, ok = [], adv <= DDP_TOL["state"]
        for stage, groups in ref["after"].items():
            for net, want in groups.items():
                got = [q["after"][stage][net] for q in parts]
                m, e = _param_excess(got[0], want)
                same = torch.equal(got[0], got[1])
                ok &= same and (e <= 0 or not gated)
                cells.append(f"{stage}/{net} {m:.3e} ({e:.3e}){'' if same else ' ranks differ'}")
        print(f"DDP parity {key} stages on the one-process rollout: advantages max abs "
              f"{adv:.3e} (tol {DDP_TOL['state']:g}); parameters after each stage, max abs diff "
              "(excess over 1e-4 + 1e-3 |p|; ranks bit-identical unless said) "
              + ", ".join(cells) + ("" if gated else " (a reading)"), flush=True)
        if not ok:
            bad.append(f"{key} stages: 2 ranks disagree with one process")
    print(f"DDP parity: one process {t_one:.1f} s, 2 ranks {t_two:.1f} s (spawn, build, every "
          "case)", flush=True)
    if bad:
        raise SystemExit("DDP parity: " + "; ".join(bad))


def env_steps(runner, steps):
    """`steps` control steps of the runner's env with zero actions, on a
    copy of its state (a callable)."""
    def run():
        z = torch.zeros(runner.env.num_envs, 12, device=runner.env.device)
        s = runner.env_state
        with torch.no_grad():
            for _ in range(steps):
                s, _ = runner.env.step(s, z)
    return run


def big_training(label, cli, argv):
    """`cli`'s build and train for the 32k task of `argv` (with --shard) in
    a one-rank NCCL group on the card, timed as the train phases; the env
    step's busy share (two steps profiled against two unprofiled).  Returns
    timed_training's dict; the caller closes the group."""
    import torch.distributed as dist

    res = timed_training(label, cli, argv, BIG_ENVS, probe_steps=0)
    runner = res["runner"]
    shard = runner.env.shard
    print(f"{label}: process group {dist.get_backend()}, world {dist.get_world_size()}, "
          f"{shard}; {res['collectives']} all-reduces in training, "
          f"{res['collective_ms']:.1f} ms", flush=True)
    if dist.get_backend() != "nccl" or shard is None or shard.num_envs != BIG_ENVS:
        raise SystemExit(f"{label}: not a one-rank NCCL group over {BIG_ENVS} envs")
    if res["collectives"] == 0:
        raise SystemExit(f"{label}: the sharded run made no collective")
    step_ms = env_step_ms(runner, 2)
    res["step_ms"] = step_ms
    res["busy"] = train_busy_share(f"{label} env step", env_steps(runner, 2), 2 * step_ms,
                                   what="two env steps (zero actions)")
    return res


def _state_reads_back(runner, label):
    """The exact-resume state file beside the newest slim checkpoint holds
    the runner's iteration, its env positions and (BBC) its ring."""
    from agility_tpu_torch.io import checkpoint as ckpt

    path = ckpt.latest(runner.log_dir)
    saved = torch.load(ckpt.state_path(path), map_location="cpu")
    same = (saved["iteration"] == runner.current_iteration
            and torch.equal(saved["env_state"]["sim"]["base_pos"],
                            runner.env_state.sim.base_pos.cpu()))
    if "ring" in saved:
        same &= torch.equal(saved["ring"]["data"], runner.train_state.ring.data.cpu())
    print(f"{label}: exact-resume state {os.path.basename(ckpt.state_path(path))} "
          f"({os.path.getsize(ckpt.state_path(path)) / 2**20:.1f} MiB) read back equal {same}",
          flush=True)
    if not same:
        raise SystemExit(f"{label}: the exact-resume state does not read back equal")


def phase_train_32k(iters=1):
    """cli/train_bbc --task go2_locomotion_32k --shard (32768 envs on the
    8 x 8 terrain, the full AlgoCfg) in a one-rank NCCL group for `iters`
    iteration(s); then K1 and K2 against their plain versions on its env
    at that width.  Returns (launches, K1 rows, K2 rows)."""
    from agility_tpu_torch.cli import train_bbc
    from agility_tpu_torch.dist import mesh
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.policy import build_policy
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    label = "BBC train 32k"
    root = _log_root()
    try:
        res = big_training(label, train_bbc, [
            "--task", "go2_locomotion_32k", "--shard", "--max_iterations", str(iters),
            "--device", "cuda", "--log_root", root, "--log_every", "1"])
        runner, launches = res["runner"], res["launches"]
        env, ts = runner.env, runner.train_state
        T = runner.cfg.num_steps_per_env
        m = metrics_to_host(runner.last_metrics)
        finite = all(bool(torch.isfinite(p).all()) for k in ("ac", "est", "disc")
                     for p in getattr(ts, k).parameters()) and all(map(np.isfinite, m.values()))
        print(f"{label}: ring {ts.ring.size} rows of {ts.ring.capacity} "
              f"({ts.ring.data.numel() * 4 / 2**20:.1f} MiB); metrics {json.dumps(m)}",
              flush=True)
        path = ckpt.latest(runner.log_dir)
        policy = build_policy(env.cfg, ckpt.params_from_jax(ckpt.read_msgpack(path)), "cuda")
        same = all(torch.equal(a, b) for mine, back in ((ts.ac, policy.ac), (ts.est, policy.est))
                   for a, b in zip(mine.state_dict().values(), back.state_dict().values()))
        print(f"{label}: slim checkpoint {os.path.basename(path)} read back equal {same}",
              flush=True)
        _state_reads_back(runner, label)
        want = dict(contact_lcp=env.engine_cfg.decimation * T * iters,
                    terrain_window=T * iters, scandots=0)
        if launches != want:
            raise SystemExit(f"{label}: launches {launches}, want {want}")
        if not finite:
            raise SystemExit(f"{label}: a parameter or metric is not finite")
        if ts.ring.size != iters * T * BIG_ENVS or ts.ring.capacity != 983_040:
            raise SystemExit(f"{label}: the ring holds the wrong number of rows")
        if not same:
            raise SystemExit(f"{label}: the slim checkpoint does not read back equal")
        sim = runner.env_state.sim
        k1 = phase_k1([("bbc_32k", env, sim, env.params)])
        k2 = phase_k2([bbc_window_case("bbc_32k", env, sim, env.params)])
        return launches, k1, k2
    finally:
        mesh.close()
        shutil.rmtree(root, ignore_errors=True)


def phase_tsc_train_32k(iters=1):
    """cli/train_tsc --task go2_32k --shard (32768 envs on 256 courses, the
    teacher flags, the frozen bbc_final, the full TscAlgoCfg) in a one-rank
    NCCL group for `iters` iteration(s), the world's generation timed; then
    K1, K2 and K3 against their plain versions on its world at that width.
    Returns (launches, K1 rows, K2 rows, K3 rows)."""
    from agility_tpu_torch.cli import train_tsc
    from agility_tpu_torch.dist import mesh
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host
    from agility_tpu_torch.terrain import obstacle

    label = "TSC train 32k"
    root = _log_root()
    generate, world_s = obstacle.generate, []

    def timed_generate(*a, **kw):
        t0 = time.perf_counter()
        out = generate(*a, **kw)
        world_s.append(time.perf_counter() - t0)
        return out

    obstacle.generate = timed_generate
    try:
        res = big_training(label, train_tsc, [
            "--task", "go2_32k", "--shard", "--bbc_path", TSC_BBC, "--randomize_start",
            "--randomize_base_mass", "--randomize_base_com", "--push_robots",
            "--max_iterations", str(iters), "--device", "cuda", "--log_root", root,
            "--log_every", "1"])
        obstacle.generate = generate
        runner, launches = res["runner"], res["launches"]
        env, ts = runner.env, runner.train_state
        T = runner.cfg.num_steps_per_env
        m = metrics_to_host(runner.last_metrics)
        finite = all(bool(torch.isfinite(p).all()) for k in ("ac", "est")
                     for p in getattr(ts, k).parameters()) and all(map(np.isfinite, m.values()))
        std_min = float(ts.ac.std.detach().min())
        print(f"{label}: the 256-course world ({tuple(env.grid.height.shape)} cells) generated "
              f"in {sum(world_s):.2f} s of the {res['build_s']:.1f} s build; priv_reg_counter "
              f"{ts.priv_reg_counter}, std min {std_min:.4f}; success rate "
              f"{float(runner.env_state.success_rate):.4f}; metrics {json.dumps(m)}", flush=True)
        path = ckpt.latest(runner.log_dir)
        back = ckpt.params_from_jax_tsc(ckpt.read_msgpack(path))
        same = all(torch.equal(v.cpu(), back[name][k]) for name, mod in (
            ("actor_critic", ts.ac), ("estimator", ts.est)) for k, v in mod.state_dict().items())
        print(f"{label}: slim checkpoint {os.path.basename(path)} read back equal {same}",
              flush=True)
        _state_reads_back(runner, label)
        want = dict(contact_lcp=env.engine_cfg.decimation * T * iters,
                    terrain_window=T * iters, scandots=T * iters)
        if launches != want:
            raise SystemExit(f"{label}: launches {launches}, want {want}")
        if not finite:
            raise SystemExit(f"{label}: a parameter or metric is not finite")
        if ts.priv_reg_counter != iters + 1 or not std_min >= np.float32(runner.cfg.min_std):
            raise SystemExit(f"{label}: priv_reg_counter {ts.priv_reg_counter} or std min "
                             f"{std_min} off")
        if not same:
            raise SystemExit(f"{label}: the slim checkpoint does not read back equal")
        s = press_into_roof(env, runner.env_state, 64)
        k1 = phase_k1([("tsc_32k", env, s.sim,
                        env.base_params._replace(hf_weights=env._weights(s)))])
        grid, c, w, sc, px, py = course_case(BIG_ENVS, env=env)
        k2 = phase_k2([("tsc_32k", grid, c, 32, w)])
        k3 = phase_k3([("tsc_32k", (grid, sc, 34, w, px, py))])
        return launches, k1, k2, k3
    finally:
        obstacle.generate = generate
        mesh.close()
        shutil.rmtree(root, ignore_errors=True)


def _nt_to(nt, dev):
    """A copy of a (nested) NamedTuple of tensors on `dev`."""
    return type(nt)(*(_nt_to(x, dev) if isinstance(x, tuple) and hasattr(x, "_fields")
                      else x.to(dev) if isinstance(x, torch.Tensor) else x for x in nt))


def phase_vision_parity(num_envs=64, courses=8, steps=8):
    """One depth-student iteration on the card (kernels) against the CPU
    (plain versions), T = 8 (camera chunks of 5 and 3), from one state, the
    teacher model_12000 and the frozen bbc_final, the same student weights
    and the same draws (the CPU's, copied).  Command noise is off: it draws
    from the env's generator, which differs on the card.

    Tolerances: the refresh images by the crossing rule (raycast.crossing_mask,
    the pixels it leaves out at most 0.5%), DEPTH_TOL m at worst and DEPTH_P99 m at the 99th
    percentile, in metres; the rollout's states
    within the SoA tolerances and its stored obs and teacher targets within
    ROLLOUT_TOL relative over the envs that did not reset (both sides must
    reset the same envs and the teacher pick the same modes); then on
    identical inputs (the CPU rollout's data): the encoder's outputs and GRU
    state within TRAIN_TOL relative, the four losses, BYOL's and the
    parameters of the encoder, the student and BYOL's online and target
    nets after the update within TRAIN_TOL relative."""
    from agility_tpu_torch.cli import registry
    from agility_tpu_torch.envs.go2_agility import Go2AgilityEnv
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.ppo_tsc import TscPPO
    from agility_tpu_torch.learn.vision_tsc import TscVision, VisionCfg, VisionData
    from agility_tpu_torch.render import raycast

    cfg = registry.apply_overrides(registry.get("go2")[0](), **{
        "env.num_envs": num_envs, "obstacle.courses": courses,
        "domain_rand.randomize_action": False})
    bbc = ckpt.load_bbc_frozen(TSC_BBC)
    teacher = ckpt.params_from_jax_tsc(ckpt.read_msgpack(TSC_CHECKPOINT))
    vis = {}
    for dev in ("cuda", "cpu"):
        alg = TscPPO(Go2AgilityEnv(cfg, dev, seed=0), bbc, seed=0)
        alg._ac0.load_state_dict(teacher["actor_critic"])
        alg._est0.load_state_dict(teacher["estimator"])
        vis[dev] = TscVision(alg.env, alg._ac0, alg._est0, alg.bbc_ac,
                             VisionCfg(num_steps_per_env=steps), seed=0)
    g, c = vis["cuda"], vis["cpu"]
    c._enc0.load_state_dict(g._enc0.state_dict())
    c._byol0.load_state_dict(g._byol0.state_dict())
    c.cam_pitch = g.cam_pitch.cpu()
    gts, cts = g.init_train_state(), c.init_train_state()
    draws = c.draw()
    gdraws = _nt_to(draws, "cuda")
    refresh_states = []
    render = c.render
    c.render = lambda es, noise: refresh_states.append(es) or render(es, noise)
    es = g.env.init_state()
    ges, gdata, _, _ = g.rollout(gts, es, gdraws.depth)
    ces, cdata, _, _ = c.rollout(cts, _to(es, "cpu"), draws.depth)
    del c.render

    # envs that reset draw their new state from each side's own generator
    reset_g = (ges.episode_length != es.episode_length + steps).cpu()
    reset_c = ces.episode_length != es.episode_length.cpu() + steps
    keep = ~(reset_g | reset_c)
    errs = {k: float((getattr(ges.sim, k).cpu() - getattr(ces.sim, k))[keep].abs().max())
            for k in SOA_TOL}
    modes = torch.equal(gdata.actions_teacher[..., 0].cpu()[:, keep],
                        cdata.actions_teacher[..., 0][:, keep])
    okeq = torch.equal(gdata.dyaw_ok.cpu()[:, keep], cdata.dyaw_ok[:, keep])
    rerr = {k: _rel(getattr(gdata, k).cpu()[:, keep], getattr(cdata, k)[:, keep])
            for k in ("obs", "actions_teacher", "prop_masked")}
    span = c.cam.far - c.cam.near
    masks = torch.stack([raycast.crossing_mask(c.cam, c.env.grid, x.sim.base_pos,
                                               x.sim.base_quat, c.cam_pitch, c.env._weights(x))
                         for x in refresh_states])
    masks &= keep[None, :, None, None]
    derr = (gdata.depth.cpu() - cdata.depth).abs()[masks] * span
    n_out = int((~masks[:, keep]).sum())
    n_px = masks[:, keep].numel()
    d_max, d_p99 = float(derr.max()), float(torch.quantile(derr[:2 ** 24], 0.99))
    print(f"vision parity {num_envs} envs x {courses} courses x {steps} steps (chunks "
          f"{cdata.chunks}), rollout card vs CPU: {int((~keep).sum())} envs reset; teacher "
          f"modes equal {modes}, dyaw-ok equal {okeq}; "
          + ", ".join(f"{k} {v:.3e} (tol {SOA_TOL[k]:g})" for k, v in errs.items())
          + "; stored (relative, tol " + f"{ROLLOUT_TOL:g}) "
          + ", ".join(f"{k} {v:.3e}" for k, v in rerr.items())
          + f"; refresh images: {n_out} of {n_px} pixels outside the crossing rule, max "
          f"|card - CPU| {d_max:.3e} m (tol {DEPTH_TOL:g}), 99th percentile {d_p99:.3e} m (tol "
          f"{DEPTH_P99:g})", flush=True)
    if not torch.equal(reset_g, reset_c):
        raise SystemExit("vision parity: the card and the CPU reset different envs")
    if not (modes and okeq and all(np.isfinite(v) and v <= SOA_TOL[k] for k, v in errs.items())):
        raise SystemExit("vision parity: the card's rollout disagrees with the CPU's")
    if not all(np.isfinite(v) and v <= ROLLOUT_TOL for v in rerr.values()):
        raise SystemExit("vision parity: the card's rollout stored other obs or targets")
    if not (d_max <= DEPTH_TOL and d_p99 <= DEPTH_P99 and n_out <= 5e-3 * n_px):
        raise SystemExit("vision parity: the card's depth images disagree with the CPU's")

    # the encoder and the update on identical inputs: the CPU rollout's data
    gin = VisionData(*(x.cuda() if isinstance(x, torch.Tensor) else x for x in cdata))
    enc_err, hg, hc = 0.0, gts.hidden, cts.hidden
    with torch.no_grad():
        for r in range(len(cdata.chunks)):
            go = g._encode(gts.enc, gin.depth[r], gin.prop_masked[r], hg)
            co = c._encode(cts.enc, cdata.depth[r], cdata.prop_masked[r], hc)
            enc_err = max(enc_err, *(_rel(a, b) for a, b in zip(go, co)))
            hg, hc = go[-1], co[-1]
        gl, cl = g.losses(gts, gin), c.losses(cts, cdata)
    loss_err = {k: _rel(gl[k], cl[k]) for k in cl}
    gm, cm = g.update(gts, gin, gdraws), c.update(cts, cdata, draws)
    m_err = max(_rel(gm[k], cm[k]) for k in cm)
    p_err = {k: _rel(torch.cat([t.flatten() for t in getattr(gts, k).parameters()]),
                     torch.cat([t.flatten() for t in getattr(cts, k).parameters()]))
             for k in ("enc", "actor", "byol", "byol_target")}
    print(f"vision parity, on identical inputs card vs CPU (relative, tol {TRAIN_TOL:g}): "
          f"encoder outputs and GRU state {enc_err:.3e}; losses "
          + ", ".join(f"{k} {v:.3e}" for k, v in loss_err.items())
          + f"; update metrics {m_err:.3e}; parameters after the update "
          + ", ".join(f"{k} {v:.3e}" for k, v in p_err.items()), flush=True)
    if not all(np.isfinite(v) and v <= TRAIN_TOL
               for v in (enc_err, m_err, *loss_err.values(), *p_err.values())):
        raise SystemExit("vision parity: the card's encoder or update disagrees with the CPU's")


def phase_vision_train(root, iters):
    """cli/train_tsc --use_camera at full width (camera_num_envs = 256 envs
    on 64 courses, the full VisionCfg, the 87 x 58 camera with 32 march
    samples), its teacher model_12000 resolved through `root` (a link, so
    nothing is written under logs/), the frozen bbc_final, for `iters`
    iterations.  Returns (the kernels' launches, the checkpoint written)."""
    from agility_tpu_torch.cli import train_tsc
    from agility_tpu_torch.io import checkpoint as ckpt
    from agility_tpu_torch.learn.ssinfogail import metrics_to_host

    link_teacher(root)
    label = "TSC vision train"
    res = timed_training(
        label, train_tsc,
        ["--use_camera", "--courses", "64", "--bbc_path", TSC_BBC, "--log_root", root,
         "--proj_name", "agility", "--resumeid", "r5", "--exptid", "vis", "--max_iterations",
         str(iters), "--device", "cuda", "--log_every", "1"], VISION_ENVS)
    runner, launches, it_ms, its, peak = (res[k] for k in ("runner", "launches", "it_ms", "its",
                                                           "peak"))
    alg, ts = runner.alg, runner.train_state
    if runner.env.num_envs != VISION_ENVS:
        raise SystemExit(f"{label}: {runner.env.num_envs} envs, not camera_num_envs")
    T, R = runner.cfg.num_steps_per_env, alg.n_refresh()
    m = metrics_to_host(runner.last_metrics)
    finite = all(bool(torch.isfinite(p).all()) for mod in (ts.enc, ts.actor, ts.byol,
                                                           ts.byol_target)
                 for p in mod.parameters()) and all(map(np.isfinite, m.values()))
    for i, it in enumerate(its):
        total = sum(it.values())
        print(f"{label} iteration {i}: the ray-march {it['render'] / R:.2f} ms a refresh "
              f"({R} refreshes, {100 * it['render'] / total:.2f}% of the iteration's events); "
              f"estimator and proprio before it {it['prep']:.1f} ms, render and process "
              f"{it['render'] + it['process']:.1f} ms, encode "
              f"{it['encode']:.1f}, heads/commands/BBC {it['act']:.1f}, env step "
              f"{it['env']:.1f}, update {it['update']:.1f}, BYOL {it['byol']:.1f} ms",
              flush=True)
    path = ckpt.latest(runner.log_dir, prefix="vision")
    back = ckpt.params_from_jax_vision(ckpt.read_msgpack(path))
    same = all(torch.equal(v.cpu(), back[name][k]) for name, mod in (
        ("encoder", ts.enc), ("actor_critic", ts.actor)) for k, v in mod.state_dict().items())
    print(f"{label}: {VISION_ENVS} envs x 64 courses, it {ts.it}; metrics {json.dumps(m)}; "
          f"checkpoint {os.path.basename(path)} read back by params_from_jax_vision, tensors "
          f"equal {same}; peak {peak / 2**30:.3f} GiB", flush=True)
    want = dict(contact_lcp=runner.env.engine_cfg.decimation * T * iters,
                terrain_window=T * iters, scandots=T * iters)
    if launches != want:
        raise SystemExit(f"{label}: launches {launches}, want {want}")
    if not finite:
        raise SystemExit(f"{label}: a parameter or metric is not finite")
    if os.path.basename(path) != f"vision_{iters}.msgpack" or not same:
        raise SystemExit(f"{label}: vision_{iters}.msgpack missing or not read back equal")

    def one_iteration():
        runner.train_state, runner.env_state, _ = alg.train_iteration(ts, runner.env_state)
    train_busy_share(label, one_iteration, it_ms)
    return launches, path


def phase_vision_play(num_envs, steps, student):
    """cli/play_tsc --use_camera at `num_envs` envs on 64 courses with the
    teacher model_12000 (its estimator), the frozen bbc_final and the
    student checkpoint `student`, for `steps` control steps."""
    from agility_tpu_torch.cli import play_tsc
    from agility_tpu_torch.physics import heightfield as hf

    args = play_tsc.get_args(["--device", "cuda", "--num_envs", str(num_envs), "--courses",
                              "64", "--steps", str(steps), "--checkpoint", TSC_CHECKPOINT,
                              "--bbc_path", TSC_BBC, "--use_camera", "--vision_checkpoint",
                              student])
    _counts_zero()
    res = play_tsc.run(args)
    launches = _counts()
    env, s = res["env"], res["state"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (*s.sim, s.obs_buf, s.obs_bbc_buf, s.seesaw_theta))
    pos = s.sim.base_pos
    floor = hf.sample_height(env.grid, pos[:, 0], pos[:, 1], env._weights(s))
    med_h = float((pos[:, 2] - floor).median())
    want = dict(contact_lcp=env.engine_cfg.decimation * res["steps"],
                terrain_window=res["steps"], scandots=res["steps"])
    print(f"TSC vision play: {num_envs} envs x 64 courses x {steps} control steps (camera every "
          f"{res['policy'].interval}), launches {launches} (want {want}), all states finite "
          f"{finite}, median base height over the folded floor {med_h:.4f} m; episodes "
          f"{res['episodes']}, course completions {res['completions']}, "
          f"{res['env_steps_per_s']:.1f} env-steps/s on {torch.cuda.get_device_name(0)}",
          flush=True)
    if launches != want:
        raise SystemExit("TSC vision play: a kernel's launch count differs from the steps run")
    if not finite:
        raise SystemExit("TSC vision play: non-finite state")
    if not 0.15 <= med_h <= 0.45:
        raise SystemExit("TSC vision play: median base height over the floor outside "
                         "[0.15, 0.45] m")
    tsc_busy_share(res, num_envs)
    return launches


def env_step_ms(runner, steps=8):
    """Milliseconds of one control step of the runner's env with zero
    actions (no policy, no trainer), on a copy of its state: the host clock
    around `steps` steps, synchronised.  Kernel launches here are outside
    any counted window."""
    env = runner.env
    z = torch.zeros(env.num_envs, 12, device=env.device)
    s = runner.env_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            s, _ = env.step(s, z)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def teacher_iteration(runner):
    """One more train iteration of a BBC or TSC teacher runner, in place."""
    def run():
        out = runner.alg.train_iteration(runner.train_state, runner.env_state, runner.disc_hist,
                                         runner.current_iteration)
        runner.train_state, runner.env_state, runner.disc_hist, _ = out
    return run


def train_busy_share(label, one_iteration, it_ms, what="one iteration"):
    """Device ops and busy time (the union of kernel, copy and fill
    intervals) of one more train iteration (`one_iteration()`) under
    torch.profiler, against the unprofiled iteration time.  A reading, not
    a gate.  Returns the busy share."""
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(activities=[ProfilerActivity.CUDA]) as prof:
        one_iteration()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans = np.array(sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                            if e.device_type() == torch.autograd.DeviceType.CUDA), dtype=np.int64)
    busy = 0
    if len(spans):
        ends = np.maximum.accumulate(spans[:, 1])
        gaps = np.maximum(spans[1:, 0] - ends[:-1], 0)
        busy = int(ends[-1] - spans[0, 0] - gaps.sum())
    print(f"{label} profile: {what} (profiled {wall:.1f} ms): {len(spans)} device ops, "
          f"device busy {busy / 1e6:.2f} ms, {100 * busy / 1e6 / it_ms:.1f}% of the unprofiled "
          f"{it_ms:.1f} ms", flush=True)
    return busy / 1e6 / it_ms


def main():
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from agility_tpu_torch.kernels import build
    from agility_tpu_torch.kernels import contact_lcp as k1
    from agility_tpu_torch.kernels import scandots as k3
    from agility_tpu_torch.kernels import terrain_window as k2

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    # one nvcc per source, all started together: each load() waits on its
    # own nvcc process, so the threads only wait
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.load, KERNELS))
    built = [k for k in KERNELS if k in build.ptxas_info]
    print(f"build: {built or 'nothing'} with nvcc for sm_90a (one process each, in parallel) "
          f"in {time.perf_counter() - t0:.2f} s; already built: "
          f"{[k for k in KERNELS if k not in built]} under {build.BUILD_DIR}", flush=True)
    for name in built:
        print(f"ptxas {name}:\n{build.ptxas_info[name].strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    rows, seconds, t = {}, {}, time.perf_counter()
    bbc = bbc_case()
    tmp_root = _log_root()
    try:
        for name, phase in (
                ("K1", lambda: phase_k1([("bbc", *bbc), ("tsc", *tsc_case()),
                                         ("tsc_vision", *tsc_case(VISION_ENVS))])),
                ("K2", lambda: phase_k2(k2_cases(bbc))),
                ("K3", lambda: phase_k3([("tsc", k3_case(TSC_ENVS)),
                                         ("tsc_vision", k3_case(VISION_ENVS))])),
                ("bench", lambda: phase_bench(NUM_ENVS, TSC_ENVS, BENCH_ITERS)),
                ("parity", phase_parity), ("TSC parity", phase_tsc_parity),
                ("BBC slice", lambda: phase_slice(NUM_ENVS, STEPS)),
                ("K1 per-env", lambda: phase_k1_per_env(*bbc)),
                ("per-env parity", phase_per_env_parity),
                ("BBC per-env slice pgs", lambda: phase_per_env_slice(
                    NUM_ENVS, PER_ENV_STEPS, "pgs", rows["BBC slice"][1])),
                ("BBC per-env slice soft", lambda: phase_per_env_slice(
                    NUM_ENVS, PER_ENV_STEPS, "soft", rows["BBC slice"][1])),
                ("PGS contact frames", lambda: phase_pgs_contact_frames(NUM_ENVS, PGS_STEPS)),
                ("TSC slice", lambda: phase_tsc_slice(TSC_ENVS, TSC_STEPS, tmp_root)),
                ("train parity", phase_train_parity),
                ("BBC train", lambda: phase_train(NUM_ENVS, TRAIN_ITERS)),
                ("BBC mocap", lambda: phase_bbc_mocap(NUM_ENVS, tmp_root)),
                ("export", lambda: phase_export(tmp_root, bbc)),
                ("TSC train parity", phase_tsc_train_parity),
                ("DDP parity", phase_ddp_parity),
                ("TSC train", lambda: phase_tsc_train(TSC_ENVS, TRAIN_ITERS)),
                ("vision parity", phase_vision_parity),
                ("vision train", lambda: phase_vision_train(tmp_root, TRAIN_ITERS)),
                ("vision play", lambda: phase_vision_play(VISION_ENVS, VISION_STEPS,
                                                          rows["vision train"][1])),
                ("BBC train 32k", phase_train_32k), ("TSC train 32k", phase_tsc_train_32k),
                # last: its device-op counts (torch.profiler) slow the host's later launches
                ("env ablation", lambda: phase_env_ablation(NUM_ENVS, TSC_ENVS, ABLATE_T))):
            t_phase = time.perf_counter()
            rows[name] = phase()
            seconds[name] = time.perf_counter() - t_phase
            print(f"[{name} done at {time.perf_counter() - t:.1f} s; the phase took "
                  f"{seconds[name]:.1f} s]", flush=True)
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)

    # the kernels at the 32k shapes, checked in the 32k phases
    for phase in ("BBC train 32k", "TSC train 32k"):
        for k, r in zip(("K1", "K2", "K3"), rows[phase][1:]):
            rows[k].update(r)
    rows["K1"].update(rows["K1 per-env"])
    paths = dict(bbc_play=rows["BBC slice"][0],
                 bbc_play_per_env=rows["BBC per-env slice pgs"][0],
                 bbc_play_per_env_soft=rows["BBC per-env slice soft"][0],
                 bbc_pgs_contact_frames=rows["PGS contact frames"][0], tsc_play=rows["TSC slice"],
                 bbc_train=rows["BBC train"], bbc_mocap_train=rows["BBC mocap"],
                 tsc_train=rows["TSC train"],
                 tsc_vision_train=rows["vision train"][0], tsc_vision_play=rows["vision play"],
                 bbc_train_32k=rows["BBC train 32k"][0], tsc_train_32k=rows["TSC train 32k"][0],
                 **rows["bench"])
    keys = ("ms", "flushed_ms", "plain_ms", "bound_ms", "bound_by", "share")
    kernels = []
    # each kernel's headline numbers are those of its first shape: K1 at the
    # BBC's (warm, 5 sweeps), K2 and K3 at the TSC's
    for mod, name, r, head in ((k1, "contact_lcp", rows["K1"], "bbc warm"),
                               (k2, "terrain_window", rows["K2"], "tsc"),
                               (k3, "scandots", rows["K3"], "tsc")):
        by_path = {p: n[name] for p, n in paths.items()}
        kernels.append(dict(
            name=name, route="cuda", source=mod.SOURCE, replaces=mod.TPU_KERNEL,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(v["max_abs_err"] for v in r.values()),
            **{k: r[head][k] for k in keys}, library_ms=None,
            by_shape={shape: {k: v[k] for k in keys + ("sectors", "routes") if k in v}
                      for shape, v in r.items()}))
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()}),
          flush=True)
    print(f"chip_smoke: every phase passed; total wall time {time.perf_counter() - t_script:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
