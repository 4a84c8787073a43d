"""Where the SoA physics substep spends its time (counterpart of the JAX
package's tools/bench_substep.py): partial substeps built from
physics/soa.py's pieces, each integrated and fed back step after step, so
that consecutive rows differ by one piece:

  fk + sphere geometry           soa.fk_vel, sphere_geometry
  + CRBA factors + bias + solve  link_coms, mass_factors, bias_forces, solve
  + detection (no LCP)           the terrain window's patch_sample_hn, the gaps
  + Delassus (0 sweeps)          jacobi_solve(iters=0): contact_problem (the G
                                 build, one bmm), K1 with 0 sweeps, apply_JT
  + 5 Jacobi sweeps              K1 with 5 sweeps
  + 10 Jacobi sweeps             K1 with 10 sweeps
  soa.substep                    the engine's substep as the program runs it
                                 (5 sweeps, relax 0.7, lam0=None), on a card
                                 the free dynamics in one kernel
                                 (kernels/free_dynamics.py) and the stages
                                 replayed from their two CUDA graphs around
                                 K1: adds the velocity clamps,
                                 limit_impulses and the joint clamps; its
                                 device ops fall below the partial rows

    python -m agility_tpu_torch.tools.bench_substep            # BENCH_ENVS=6144, one card
    BENCH_ENVS=8 BENCH_STEPS=2 python -m agility_tpu_torch.tools.bench_substep --device cpu

The JAX tool's setup: the Go2 model, a 600 x 600 grid at 0.05 m of
0.06 N(0, 1) heights from default_rng(0) (origin -15, -15), N envs at
uniform(-10, 10) in x and y and z 0.34, upright, the default joint pose at
rest, PD targets at it (kp 40, kd 1), unit friction and gains, dt 0.005,
the window (32 cells, through K2) extracted once.  Each row runs T =
BENCH_STEPS substeps from that state, z clipped to [0.1, 0.6] after each,
under the synchronised host clock, in interleaved rounds (tools/timing.py:
every row once a round, 5 rounds, median and min-max); then each row's
device operations for one substep (the largest of 3 torch.profiler
readings, after all timing; not measured on the CPU).  Prints each row's
ms and ops a substep, the differences, and a JSON line of the rows, each
with the kernels' launches a substep (K1 once in the last four rows).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from agility_tpu_torch.tools import timing

DT = 0.005
GRAVITY = (0.0, 0.0, -9.81)
SOLVE = dict(relax=0.7, baumgarte=0.2, slop=0.002, max_depen_vel=1.0, restitution=0.0)
LABELS = ("fk + sphere geometry", "+ CRBA factors + bias + solve", "+ detection (no LCP)",
          "+ Delassus (0 sweeps)", "+ 5 Jacobi sweeps", "+ 10 Jacobi sweeps", "soa.substep")
READS = 3           # profiler readings of a row's ops, the largest kept
# (name, row, the row before it): each piece is the difference of two rows
PIECES = (("fk+geometry", 0, None), ("free dynamics", 1, 0), ("detection sampling", 2, 1),
          ("delassus build", 3, 2), ("5 sweeps", 4, 3), ("5 more sweeps", 5, 4),
          ("limits + clamps", 6, 4))


def setup(N, device):
    """The JAX tool's state, gains and terrain window: (mc, sd0, inputs),
    inputs = (target, kp, kd, prm, sampler), sampler a soa.PatchSampler."""
    from agility_tpu_torch.core.urdf import build_go2_model
    from agility_tpu_torch.kernels.terrain_window import terrain_window
    from agility_tpu_torch.physics import heightfield as hf
    from agility_tpu_torch.physics import soa
    from agility_tpu_torch.physics.constants import ModelConsts

    mc = ModelConsts.from_model(build_go2_model(), device)
    rng = np.random.default_rng(0)
    hmap = (0.06 * rng.normal(size=(600, 600))).astype(np.float32)
    grid = hf.from_numpy(hmap, 0.05, origin_xy=(-15.0, -15.0), device=device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    bp = f32(np.concatenate([rng.uniform(-10, 10, (2, N)), np.full((1, N), 0.34)], 0))
    bq = f32([[0.0], [0.0], [0.0], [1.0]]).repeat(1, N)
    q = mc.default_dof_pos[:, None].repeat(1, N)
    sd0 = soa.SoAState(bp=bp, bq=bq, q=q, u=torch.zeros((18, N), device=device))
    target = mc.default_dof_pos[:, None].repeat(1, N)
    kp = torch.full((12, N), 40.0, device=device)
    kd = torch.full((12, N), 1.0, device=device)
    prm = dict(kp_scale=torch.ones((12, N), device=device),
               kd_scale=torch.ones((12, N), device=device), friction=torch.ones(N, device=device))
    # the window, extracted once outside the loop (bench_stages_tsc and the
    # env ablation attribute the control step's extraction)
    patch = terrain_window(grid, bp[:2].T.contiguous(), 32, None)
    sampler = soa.PatchSampler(patch.values.permute(1, 2, 0), patch.x0, patch.y0, grid.origin,
                               grid.hscale)
    return mc, sd0, (target, kp, kd, prm, sampler)


def steps(mc, inputs):
    """{label: one substep SoAState -> SoAState} of every row, the JAX
    tool's closures on the port's soa functions, and soa.substep."""
    from agility_tpu_torch.physics import soa
    from agility_tpu_torch.physics.engine import EngineConfig

    c = soa.consts_of(mc)
    target, kp, kd, prm, sampler = inputs

    def integrate(sd, u_new):
        u = torch.stack(u_new) if isinstance(u_new, list) else u_new
        bq = soa.q_integrate(tuple(sd.bq.unbind(0)), (u[3], u[4], u[5]), DT)
        return soa.SoAState(bp=sd.bp + DT * u[0:3], bq=torch.stack(bq), q=sd.q + DT * u[6:], u=u)

    def kinematics(sd):
        return soa.fk_vel(c, tuple(sd.bp.unbind(0)), tuple(sd.bq.unbind(0)), sd.q, sd.u)

    def free_velocity(sd, ls):
        com = soa.link_coms(c, ls)
        tau = torch.minimum(torch.maximum(kp * (target - sd.q) - kd * sd.u[6:], -c.effort),
                            c.effort)
        f = soa.mass_factors(c, ls, com)
        C = soa.bias_forces(c, ls, com, list(sd.u[6:].unbind(0)), GRAVITY)
        du = soa.solve(f, [-C[i] for i in range(6)] + [tau[d] - C[6 + d] for d in range(12)])
        return f, [sd.u[i] + DT * du[i] for i in range(18)]

    def fk_only(sd):
        cen, lever = soa.sphere_geometry(c, kinematics(sd))
        # everything folded into a fake velocity, so that nothing is dead
        dv = 1e-9 * (cen[2] + lever[0, 0])                     # (S, N)
        u_new = sd.u.clone()
        u_new[2] = u_new[2] + (dv.sum(0) - 9.81 * DT)
        return integrate(sd, u_new)

    def free_dyn(sd):
        ls = kinematics(sd)
        _, u_free = free_velocity(sd, ls)
        cen, lever = soa.sphere_geometry(c, ls)
        return integrate(sd, [u + 1e-12 * lever[0, 0].sum(0) for u in u_free])

    def full(iters, with_delassus=True):
        def step(sd):
            ls = kinematics(sd)
            f, u_free = free_velocity(sd, ls)
            cen, lever = soa.sphere_geometry(c, ls)
            h, n = sampler(cen[0], cen[1])
            phi = (cen[2] - h) * n[2] - c.sph_radius
            r = tuple(cen[k] - sd.bp[k][None] for k in range(3))
            if with_delassus:
                u_new, _, _ = soa.jacobi_solve(phi, n, r, lever, f, u_free, prm["friction"], DT,
                                               iters=iters, **SOLVE)
            else:
                pen = 1e-9 * torch.sum(torch.clamp(-phi, min=0.0) * n[2], 0)
                u_new = [u + pen for u in u_free]
            return integrate(sd, u_new)
        return step

    cfg = EngineConfig(dt=DT, gravity=GRAVITY, jacobi_iters=5, jacobi_relax=SOLVE["relax"])

    def substep(sd):
        return soa.substep(mc, cfg, sd, target, kp, kd, prm, sampler)[0]

    return dict(zip(LABELS, (fk_only, free_dyn, full(0, False), full(0), full(5), full(10),
                             substep)))


def scanned(step, sd0, T):
    """T substeps from sd0, the base's z clipped to [0.1, 0.6] after each
    (it must not walk off the window).  Returns the last state."""
    from agility_tpu_torch.physics import soa

    sd = sd0
    for _ in range(T):
        sd = step(sd)
        sd = soa.SoAState(bp=torch.cat([sd.bp[:2], sd.bp[2:].clamp(0.1, 0.6)]), bq=sd.bq,
                          q=sd.q, u=sd.u)
    return sd


def bench(device, N=6144, T=50, rounds=timing.ROUNDS):
    """Every row timed (interleaved rounds of T substeps from the same
    state), then its device ops a substep.  Returns (rows, pieces): rows
    from timing.interleaved (ms and launches a substep, ops, and
    `finite`: the last state of the last round), pieces {name: {ms, ops}}."""
    mc, sd0, inputs = setup(N, device)
    fns = steps(mc, inputs)
    last = {}

    def run(label):
        def go():
            last[label] = scanned(fns[label], sd0, T)
        return go

    with torch.no_grad():
        variants = [timing.Variant(label, run(label), per=T, ops=lambda f=fns[label]: f(sd0))
                    for label in LABELS]
        rows = timing.interleaved(variants, device, rounds)
        timing.count_device_ops(rows, variants, device, READS)
    for r in rows:
        r["finite"] = all(bool(torch.isfinite(t).all()) for t in last[r["label"]])
    pieces = {}
    for name, i, j in PIECES:
        a, b = rows[i], rows[j] if j is not None else None
        pieces[name] = dict(
            ms=a["ms"] - (b["ms"] if b else 0.0),
            ops=None if a["ops"] is None else a["ops"] - (b["ops"] if b else 0))
    pieces["5 more sweeps"]["ms_per_sweep"] = pieces["5 more sweeps"]["ms"] / 5
    return rows, pieces


def main(argv=None):
    device, label = timing.open_device(argv, "SoA substep cost attribution")
    N = int(os.environ.get("BENCH_ENVS", "6144"))
    T = int(os.environ.get("BENCH_STEPS", "50"))
    print(f"N={N}, T={T} substeps a run, on {label}", flush=True)
    rows, pieces = bench(device, N, T)
    print(timing.table(rows, "substep"), flush=True)
    print(f"\nper-substep attribution @N={N}:")
    for name, p in pieces.items():
        ops = "not measured" if p["ops"] is None else f"{p['ops']:+d}"
        print(f"  {name:<20} {p['ms']:8.3f} ms  {ops:>12} device ops")
    print(f"  full substep         {rows[-1]['ms']:8.3f} ms")
    print(json.dumps({"device": label, "num_envs": N, "T": T, "rounds": timing.ROUNDS,
                      "rows": rows, "pieces": pieces}))


if __name__ == "__main__":
    main()
