"""Go2 agility-course environment, the TSC task (counterpart of
agility_tpu/envs/go2_agility.py).

The hierarchical MDP: a high-level policy picks a behaviour mode and a
command vector every control step (`set_commands`), and a frozen BBC policy
turns those commands into joint actions for `step`.  The course is an
obstacle heightfield with goal waypoints, movable bar/tire heights (layers
with per-env weights), a passive seesaw plank (lever grid times a per-env
angle) and overhangs (a ceiling surface).  All random draws of reset and
command noise go through one `torch.Generator` kept on the env; the per-env
constants (course tables, obstacle heights, seesaw damping, domain
randomization, scandot grid) are the JAX env's numpy draws from
`default_rng(cfg.seed)`, in the same order, so they are equal.  A reset's
draws (`ResetDraws`) and set_commands' action noise may also be handed in,
so that a test can feed the JAX env's draws.

Per control step the engine gathers the contact window through kernel K2
and the observation measures the scandots through kernel K3.

Observation layout:
  obs (800)     = [prop 57 | delta_yaws 2 | obstacle one-hot 6 | scan 132 |
                   explicit 4 | priv latent 29 | prop history 10x57]
  obs_bbc (671) = [prop 57 | explicit 4 | priv latent 29 | history 570 |
                   commands 5 | eps 1 | c 5]   (fed to the frozen BBC)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from agility_tpu_torch import trace
from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.dist import mesh
from agility_tpu_torch.envs.go2_locomotion import compute_disc_features
from agility_tpu_torch.envs.tsc_config import Go2AgilityCfg
from agility_tpu_torch.kernels.scandots import scandots
from agility_tpu_torch.physics import engine as eng
from agility_tpu_torch.physics import heightfield as hf
from agility_tpu_torch.physics import patch as pt
from agility_tpu_torch.physics import soa
from agility_tpu_torch.physics.constants import ModelConsts
from agility_tpu_torch.terrain import obstacle as obst_gen
from agility_tpu_torch.terrain.obstacle import lever_arm


class AgilityState(NamedTuple):
    sim: eng.EnvState
    episode_length: torch.Tensor      # (N,) int64
    global_counter: int               # control steps taken (same for all envs)
    # BBC command interface
    commands: torch.Tensor            # (N, 5)
    latent_eps: torch.Tensor          # (N, 1)
    latent_c: torch.Tensor            # (N, 5)
    # low-level action plumbing
    actions_bbc: torch.Tensor         # (N, 12)
    last_actions_bbc: torch.Tensor
    action_history: torch.Tensor      # (N, buf, 12)
    action_hl_history: torch.Tensor   # (N, 3, 1 + 18)
    last_dof_vel: torch.Tensor
    torques_org: torch.Tensor
    last_torques_org: torch.Tensor
    # observation machinery
    obs_history: torch.Tensor         # (N, 10, 57)
    last_contacts: torch.Tensor       # (N, 4) bool
    contact_filt: torch.Tensor
    # goals
    cur_goal_idx: torch.Tensor        # (N,) int64
    reach_goal_timer: torch.Tensor    # (N,)
    cur_goals: torch.Tensor           # (N, 3)
    next_goals: torch.Tensor          # (N, 3)
    target_yaw: torch.Tensor          # (N,)
    next_target_yaw: torch.Tensor
    delta_yaw: torch.Tensor
    delta_next_yaw: torch.Tensor
    leave_goal: torch.Tensor          # (N,) bool
    reached_goal: torch.Tensor        # (N,) bool
    # per-env movable obstacle heights and the passive seesaw plank
    bar_h: torch.Tensor               # (N,)
    tire_h: torch.Tensor              # (N,)
    seesaw_theta: torch.Tensor        # (N,) plank angle (tan approx)
    seesaw_theta_d: torch.Tensor      # (N,)
    curr_count: torch.Tensor          # () int64, widens the height ranges
    success_rate: torch.Tensor        # () EMA of course completion
    spawn_goal_idx: torch.Tensor      # (N,) int64
    success_rate_s0: torch.Tensor     # () EMA over episodes spawned at goal 0
    goal_progress: torch.Tensor       # () EMA of goals gained per episode
    # bookkeeping
    episode_sums: torch.Tensor
    reset_buf: torch.Tensor
    time_out_buf: torch.Tensor
    reach_goal_cutoff: torch.Tensor   # (N,) course completed
    obs_buf: torch.Tensor             # (N, 800)
    obs_bbc_buf: torch.Tensor         # (N, 671)
    disc_obs: torch.Tensor            # (N, 49)


class TscStepOutput(NamedTuple):
    obs: torch.Tensor
    obs_bbc: torch.Tensor
    rew: torch.Tensor
    reset: torch.Tensor
    time_out: torch.Tensor
    reach_goal_cutoff: torch.Tensor
    disc_obs: torch.Tensor
    terminal_disc_obs: torch.Tensor
    episode_sums: torch.Tensor
    reward_terms: torch.Tensor


class ResetDraws(NamedTuple):
    """One reset's random draws for all N envs (the JAX env splits them
    from its key: dx, dy, dyaw, the dof scale and lin_ang from ks[0..4],
    bar and tire from ks[6], obst_idx from ks[7])."""
    dx: torch.Tensor                  # (N,) U(-rand_x_range, rand_x_range)
    dy: torch.Tensor                  # (N,) U(-rand_y_range, rand_y_range)
    dyaw: torch.Tensor                # (N,) U(-rand_yaw_range, rand_yaw_range)
    obst_idx: Optional[torch.Tensor]  # (N,) int64 start station; None without randomize_start
    dof_scale: torch.Tensor           # (N, 12) U(0.5, 1.5)
    lin_ang: torch.Tensor             # (N, 6) U(-0.5, 0.5)
    bar: torch.Tensor                 # (N,) U(0, 1), mapped onto the bar height range
    tire: torch.Tensor                # (N,) U(0, 1), mapped onto the tire height range


_INT_FIELDS = ("episode_length", "cur_goal_idx", "spawn_goal_idx", "curr_count")


def state_from_jax(js, device="cuda") -> AgilityState:
    """An AgilityState from the JAX package's AgilityState, leaf by leaf
    through numpy; the JAX PRNG key is dropped.  Lets a test start both envs
    from one state."""
    t = lambda x: torch.as_tensor(np.array(x), device=device)
    fields = {k: t(getattr(js, k)) for k in AgilityState._fields
              if k not in ("sim", "global_counter")}
    for k in _INT_FIELDS:
        fields[k] = fields[k].long()
    sim = eng.EnvState(*(t(getattr(js.sim, k)) for k in eng.EnvState._fields))
    return AgilityState(sim=sim, global_counter=int(js.global_counter), **fields)


class Go2AgilityEnv:
    """Static course and env data on `device` + step/reset functions."""

    def __init__(self, cfg: Go2AgilityCfg, device="cuda", seed: int = 0,
                 shard: Optional[mesh.EnvShard] = None):
        """`shard`: this rank's block of the cfg.env.num_envs global envs
        (dist/mesh.py); the env then holds and steps those envs alone, every
        per-env draw and per-env constant is the one-rank env's with the
        rank's rows taken, and the success EMAs are summed over all ranks'
        envs every step."""
        self.cfg = cfg
        self.device = dev = torch.device(device)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.model = build_go2_model()
        self.mc = ModelConsts.from_model(self.model, dev)
        self.dt = cfg.dt
        self.shard = shard
        self.num_envs_global = N = cfg.env.num_envs
        self.num_envs = shard.local if shard else N
        self.dim_c = len(cfg.env.mocap_category_all)
        # discrete-head index -> global mode index
        self.mocap_indices = torch.tensor(
            [list(cfg.env.mocap_category_all).index(c) for c in cfg.env.mocap_category],
            device=dev)
        self.engine_cfg = eng.EngineConfig(
            dt=cfg.sim.dt, decimation=cfg.control.decimation, solver=cfg.sim.solver,
            jacobi_iters=cfg.sim.jacobi_iters, jacobi_relax=cfg.sim.jacobi_relax,
            warm_start=cfg.sim.warm_start, patch_size=32)   # 1.6 m at the 0.05 m course scale
        # per-env constants: drawn for all N global envs, the rank's rows kept
        rows = (lambda x: shard.take(np.asarray(x))) if shard else np.asarray
        f32 = lambda x: torch.as_tensor(rows(x).astype(np.float32), device=dev)
        i64 = lambda x: torch.as_tensor(rows(x).astype(np.int64), device=dev)
        f32s = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # not per env

        # ---- obstacle course world ----
        world = obst_gen.generate(cfg.obstacle, seed=cfg.seed)
        self.world = world
        self.grid = hf.from_numpy(world.height, world.hscale, world.origin, dev,
                                  layer_id=world.layer_id, lever=world.lever,
                                  ceiling=world.ceil, ceiling_layer=world.ceil_layer)
        self.x_edge = torch.as_tensor(world.x_edge, device=dev)
        rng = np.random.default_rng(cfg.seed)
        course_id = np.arange(N) % cfg.obstacle.courses
        self.env_goals = f32(world.goals[course_id])              # (N, G, 3)
        self.goal_layer = i64(world.goal_layer[course_id])        # (N, G)
        self.obst_types = i64(world.obst_types[course_id])        # (N, 6)
        self.obst_yaws = f32(world.obst_yaws[course_id])          # (N, 6)
        self.robot_org = f32(world.robot_org[course_id])          # (N, 3)
        self.seesaw_pose = f32(world.seesaw_pose[course_id])      # (N, 5)
        self.n_goals_total = world.n_goals_total
        self.num_goals = cfg.obstacle.num_goals
        self.last_goal_repeat = cfg.obstacle.last_goal_repeat

        # per-env movable obstacle heights and plank damping U(1, 10)
        bar_h, tire_h = obst_gen.sample_obstacle_heights(cfg.obstacle, rng, N)
        if cfg.obstacle.curriculum:
            bar_h = rng.uniform(*cfg.obstacle.bar_jump_init_range, N)
            tire_h = rng.uniform(*cfg.obstacle.tire_jump_init_range, N)
        self.bar_h, self.tire_h = f32(bar_h), f32(tire_h)
        self.seesaw_damping = f32(rng.uniform(1.0, 10.0, N))

        # ---- body tables ----
        m = self.model
        self.feet_idx = m.match_bodies("foot")
        self.penalized_idx = (m.match_bodies("base") + m.match_bodies("hip")
                              + m.match_bodies("thigh") + m.match_bodies("calf"))
        self.termination_idx = (m.match_bodies("base") + m.match_bodies("hip")
                                + m.match_bodies("thigh"))
        # the same on the device: a list indexes a CUDA tensor through a copy
        # from the host, which waits for the device to finish the queued work
        self.feet_ix, self.penalized_ix, self.termination_ix = (
            torch.tensor(ix, device=dev) for ix in
            (self.feet_idx, self.penalized_idx, self.termination_idx))
        hip = np.ones(12)
        hip[[0, 3, 6, 9]] = cfg.control.hip_scale_reduction
        self.hip_scale = f32s(hip)

        # ---- domain randomization ----
        dr = cfg.domain_rand
        if dr.randomize_friction:
            friction = rng.uniform(*dr.friction_range, size=64)[rng.integers(0, 64, N)]
        else:
            friction = np.ones(N)
        added_mass = (rng.uniform(*dr.added_mass_range, N) if dr.randomize_base_mass
                      else np.zeros(N))
        com_shift = (rng.uniform(*dr.added_com_range, (N, 3)) if dr.randomize_base_com
                     else np.zeros((N, 3)))
        if dr.randomize_motor:
            kp_scale = rng.uniform(*dr.motor_strength_range, (N, 12))
            kd_scale = rng.uniform(*dr.motor_strength_range, (N, 12))
        else:
            kp_scale = kd_scale = np.ones((N, 12))
        self.base_params = eng.EnvParams(
            friction=f32(friction), kp_scale=f32(kp_scale), kd_scale=f32(kd_scale),
            added_base_mass=f32(added_mass), base_com_shift=f32(com_shift))
        self.mass_params = f32(np.concatenate([added_mass[:, None], com_shift], -1))
        self.kp = torch.full((self.num_envs, 12), cfg.control.stiffness, device=dev)
        self.kd = torch.full((self.num_envs, 12), cfg.control.damping, device=dev)

        # scandot grid (12 x 11), per env, with optional static horizontal
        # measurement noise (sum of two uniform draws)
        ob = cfg.obstacle
        gx, gy = np.meshgrid(ob.measured_points_x, ob.measured_points_y, indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
        pts = np.tile(pts[None], (N, 1, 1))
        hn = ob.measure_horizontal_noise
        if hn > 0.0:
            pts[:, :, :2] += (rng.uniform(-hn, hn, (N, gx.size, 2))
                              + rng.uniform(-hn, hn, (N, gx.size, 2)))
        self.height_points = f32(pts)                               # (N, K, 3)
        self.n_height_points = gx.size
        self.center_height_idx = self.n_height_points // 2 + 1
        # the scan window is centred on the yaw-rotated scan-grid centre and
        # sized to the grid's radius over any yaw, plus half a cell of centre
        # rounding and one cell for the min3 +x/+y tap: 34 cells by default
        cen = pts[:, :, :2].mean(axis=1)
        extent = (np.linalg.norm(pts[:, :, :2] - cen[:, None], axis=-1).max()
                  / ob.horizontal_scale)
        self.scan_center_local = f32(np.concatenate([cen, np.zeros((N, 1))], -1))
        self.scan_size = max(self.engine_cfg.patch_size, 2 * int(np.ceil(extent + 1.5)))

        scales = dataclasses.asdict(cfg.rewards.scales)
        self.reward_names = [k for k, v in scales.items() if v != 0 and k != "termination"]
        self.reward_scales = f32s([scales[k] * self.dt for k in self.reward_names])
        self.termination_scale = scales.get("termination", 0.0) * self.dt
        self.n_rew = len(self.reward_names) + (1 if self.termination_scale else 0)
        cr = cfg.commands.ranges
        self.cmd_ranges = {k: f32s(getattr(cr, k))
                           for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw")}
        self.max_episode_length = cfg.max_episode_length

    def _rand(self, *shape):
        """U[0, 1) draws of `shape`, whose first axis runs over this env's
        envs: drawn at the global width and the rank's envs taken."""
        if self.shard is None:
            return torch.rand(shape, generator=self.gen, device=self.device)
        full = (self.num_envs_global,) + shape[1:]
        return self.shard.take(torch.rand(full, generator=self.gen, device=self.device))

    def _uniform(self, lo, hi, *shape):
        return lo + (hi - lo) * self._rand(*shape)

    # ------------------------------------------------------------------

    def _weights(self, state) -> torch.Tensor:
        """(N, 3) heightfield weights: [bar height, tire height, plank tilt]."""
        return torch.stack([state.bar_h, state.tire_h, state.seesaw_theta], dim=-1)

    def draw_reset(self) -> ResetDraws:
        """A reset's draws from the env's generator, in the order the reset
        has always drawn them."""
        N, e = self.num_envs, self.cfg.env
        dx = self._uniform(-e.rand_x_range, e.rand_x_range, N)
        dy = self._uniform(-e.rand_y_range, e.rand_y_range, N)
        dyaw = self._uniform(-e.rand_yaw_range, e.rand_yaw_range, N)
        obst_idx = None
        if e.randomize_start:
            obst_idx = torch.randint(0, self.obst_types.shape[1], (self.num_envs_global,),
                                     generator=self.gen, device=self.device)
            obst_idx = self.shard.take(obst_idx) if self.shard else obst_idx
        dof_scale = self._uniform(0.5, 1.5, N, 12)
        lin_ang = self._uniform(-0.5, 0.5, N, 6)
        return ResetDraws(dx, dy, dyaw, obst_idx, dof_scale, lin_ang, self._rand(N), self._rand(N))

    def _sample_heights_where(self, state, mask, draws: Optional[ResetDraws] = None):
        """Per-env bar/tire heights drawn at reset, within ranges widened by
        the curriculum count; `draws` supplies the unit uniforms (bar, tire),
        else they come from the env's generator."""
        ob = self.cfg.obstacle
        if ob.curriculum:
            lo_b, lo_t = ob.bar_jump_init_range[0], ob.tire_jump_init_range[0]
            widen = state.curr_count.float() * ob.curr_step
            hi_b = torch.clamp(ob.bar_jump_init_range[1] + widen, max=ob.bar_jump_max_range[1])
            hi_t = torch.clamp(ob.tire_jump_init_range[1] + widen, max=ob.tire_jump_max_range[1])
        else:
            (lo_b, hi_b), (lo_t, hi_t) = ob.bar_jump_range, ob.tire_jump_range
        if draws is None:
            bar_u, tire_u = self._rand(self.num_envs), self._rand(self.num_envs)
        else:
            bar_u, tire_u = draws.bar, draws.tire
        bar_new = lo_b + (hi_b - lo_b) * bar_u
        tire_new = lo_t + (hi_t - lo_t) * tire_u
        return torch.where(mask, bar_new, state.bar_h), torch.where(mask, tire_new, state.tire_h)

    def _gather_goals(self, state, idx):
        """(N, 3) goal at per-env index (clamped); bar/tire goals follow the
        env's movable height."""
        idx = torch.clamp(idx, 0, self.n_goals_total - 1)
        ar = torch.arange(self.num_envs, device=self.device)
        g, layer = self.env_goals[ar, idx], self.goal_layer[ar, idx]
        add = torch.where(layer == obst_gen.LAYER_BAR, state.bar_h,
                          torch.where(layer == obst_gen.LAYER_TIRE, state.tire_h, 0.0))
        return torch.cat([g[:, :2], (g[:, 2] + add)[:, None]], dim=-1)

    # ==================================================================

    def init_state(self) -> AgilityState:
        N, dev = self.num_envs, self.device
        z = lambda *s: torch.zeros(s, device=dev)
        zl = lambda *s: torch.zeros(s, dtype=torch.long, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        quat = z(N, 4)
        quat[:, 3] = 1.0
        latent_c = z(N, self.dim_c)
        latent_c[:, 2] = 1.0
        e = self.cfg.env
        s = AgilityState(
            sim=eng.EnvState(base_pos=z(N, 3), base_quat=quat,
                             dof_pos=self.mc.default_dof_pos.repeat(N, 1), u=z(N, 18)),
            episode_length=zl(N), global_counter=0, commands=z(N, 5), latent_eps=z(N, 1),
            latent_c=latent_c, actions_bbc=z(N, 12), last_actions_bbc=z(N, 12),
            action_history=z(N, self.cfg.domain_rand.action_buf_len, 12),
            action_hl_history=z(N, 3, e.num_actions_hl), last_dof_vel=z(N, 12),
            torques_org=z(N, 12), last_torques_org=z(N, 12),
            obs_history=z(N, e.history_len, 57), last_contacts=zb(N, 4),
            contact_filt=zb(N, 4), cur_goal_idx=zl(N), reach_goal_timer=z(N),
            cur_goals=z(N, 3), next_goals=z(N, 3), target_yaw=z(N), next_target_yaw=z(N),
            delta_yaw=z(N), delta_next_yaw=z(N), leave_goal=zb(N), reached_goal=zb(N),
            bar_h=self.bar_h, tire_h=self.tire_h,
            seesaw_theta=torch.full((N,), obst_gen.SEESAW_THETA_REST, device=dev),
            seesaw_theta_d=z(N), curr_count=zl(), success_rate=z(), spawn_goal_idx=zl(N),
            success_rate_s0=z(), goal_progress=z(), episode_sums=z(N, self.n_rew),
            reset_buf=zb(N), time_out_buf=zb(N), reach_goal_cutoff=zb(N),
            obs_buf=z(N, e.num_obs), obs_bbc_buf=z(N, e.num_obs_bbc),
            disc_obs=z(N, e.num_obs_disc))
        s = self._reset_where(s, torch.ones(N, dtype=torch.bool, device=dev))
        s = s._replace(cur_goals=self._gather_goals(s, s.cur_goal_idx),
                       next_goals=self._gather_goals(s, s.cur_goal_idx + 1))
        # fill the caches with a zero-action step
        s, _ = self.step(s, z(N, 12))
        return s

    # ==================================================================
    # the hierarchical command bridge
    # ==================================================================

    def set_commands(self, state: AgilityState, hl_actions: torch.Tensor,
                     noise: Optional[torch.Tensor] = None):
        """Translate high-level hybrid actions (N, 1 + D*C) into BBC commands
        and latents.  With randomize_action the commands are scaled by
        `noise` (N, 5), U(action_noise), drawn from the env's generator where
        it is not given.  Returns (state, next_commands (N, 11))."""
        cfg = self.cfg
        nc = cfg.env.num_actions_c
        d = hl_actions[:, 0].long()
        mapped = self.mocap_indices[d]                       # global mode index
        col = d[:, None] * nc + torch.arange(nc, device=self.device)[None, :] + 1
        cmds = torch.clamp(torch.gather(hl_actions, 1, col), -1.0, 1.0)
        latent_c = torch.nn.functional.one_hot(mapped, self.dim_c).to(cmds.dtype)
        latent_eps = cmds[:, -1:]
        u = (cmds + 1.0) / 2.0
        rx, ry, rw = (self.cmd_ranges[k][mapped] for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw"))
        vx = rx[:, 0] + (rx[:, 1] - rx[:, 0]) * u[:, 0]
        vy = ry[:, 0] + (ry[:, 1] - ry[:, 0]) * u[:, 1]
        wz = rw[:, 0] + (rw[:, 1] - rw[:, 0]) * u[:, 2]
        jh, lh = cfg.commands.ranges.jump_height, cfg.commands.ranges.locomotion_height
        jump = mapped == (self.dim_c - 1)
        jump_h = (jh[0] + (jh[1] - jh[0]) * u[:, 3]) * jump
        loco_h = (lh[0] + (lh[1] - lh[0]) * u[:, 4]) * (~jump)
        commands = torch.stack([vx, vy, wz, jump_h, loco_h], dim=-1)
        if cfg.domain_rand.randomize_action:
            if noise is None:
                noise = self._uniform(*cfg.domain_rand.action_noise, *commands.shape)
            commands = commands * noise
        hl_hist = torch.cat([state.action_hl_history[:, 1:], hl_actions[:, None, :]], dim=1)
        state = state._replace(commands=commands, latent_c=latent_c, latent_eps=latent_eps,
                               action_hl_history=hl_hist)
        return state, torch.cat([commands, latent_eps, latent_c], dim=-1)

    # ==================================================================
    # step (takes the BBC's joint-space actions)
    # ==================================================================

    @trace.spanned("env.step")
    def step(self, state: AgilityState, actions_bbc: torch.Tensor
             ) -> Tuple[AgilityState, TscStepOutput]:
        cfg = self.cfg
        dr = cfg.domain_rand
        params = self.base_params._replace(hf_weights=self._weights(state))

        action_history = torch.cat([state.action_history[:, 1:], actions_bbc[:, None, :]], dim=1)
        if dr.action_delay:
            used = action_history[:, action_history.shape[1] - 1 - dr.action_delay_step]
        else:
            used = actions_bbc
        clip_a = cfg.clip_actions / cfg.control.action_scale
        acts = torch.clamp(used, -clip_a, clip_a)
        target = acts * cfg.control.action_scale * self.hip_scale + self.mc.default_dof_pos
        control = eng.Control(target=target, kp=self.kp, kd=self.kd)

        sim, (tau, tau_org), body_forces, _, _ = eng.step_batch(
            self.mc, self.engine_cfg, self.grid, state.sim, control, params)

        # --- passive seesaw plank: feet normal forces on the plank torque the
        # per-env plank angle; semi-implicit Euler at control rate with
        # viscous damping and hard stops where a plank end meets the ground
        feet_pos = soa.body_positions(self.mc, sim, self.feet_idx)          # (N, 4, 3)
        lever = lever_arm(self.seesaw_pose[:, None, :], feet_pos[:, :, 0], feet_pos[:, :, 1])
        fz = body_forces[:, self.feet_ix, 2]                                # upward on robot
        plank_tau = -torch.sum(lever * fz, dim=1)                           # reaction torque
        th_d = state.seesaw_theta_d + self.dt * (
            plank_tau - self.seesaw_damping * state.seesaw_theta_d) / obst_gen.SEESAW_INERTIA
        th = state.seesaw_theta + self.dt * th_d
        th_c = torch.clamp(th, -obst_gen.SEESAW_THETA_MAX, obst_gen.SEESAW_THETA_MAX)
        seesaw_theta_d = torch.where(th_c == th, th_d, 0.0)
        seesaw_theta = th_c

        episode_length = state.episode_length + 1
        global_counter = state.global_counter + 1
        bq = sim.base_quat
        base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])
        base_ang_vel = qm.quat_rotate_inverse(bq, sim.u[:, 3:6])
        roll, pitch, yaw = qm.euler_from_quat(bq)
        contact = torch.linalg.vector_norm(body_forces[:, self.feet_ix], dim=-1) > 2.0
        contact_filt = contact | state.last_contacts

        # --- goal machinery, on last step's gathered goals ---
        next_flag = state.reach_goal_timer > (cfg.env.reach_goal_delay / self.dt)
        cur_goal_idx = state.cur_goal_idx + next_flag.long()
        reach_goal_timer = torch.where(next_flag, 0.0, state.reach_goal_timer)
        dist = torch.linalg.vector_norm(sim.base_pos[:, :2] - state.cur_goals[:, :2], dim=-1)
        reached = dist < cfg.env.next_goal_threshold
        leave = dist > cfg.env.leave_goal_threshold
        reach_goal_timer = reach_goal_timer + reached
        target_rel = state.cur_goals[:, :2] - sim.base_pos[:, :2]
        next_rel = state.next_goals[:, :2] - sim.base_pos[:, :2]

        def heading(rel):
            nrm = torch.linalg.vector_norm(rel, dim=-1) + 1e-5
            return torch.atan2(rel[:, 1] / nrm, rel[:, 0] / nrm)

        target_yaw, next_target_yaw = heading(target_rel), heading(next_rel)
        cur_obst_type = self._obstacle_type(cur_goal_idx)

        # --- termination ---
        term_force = torch.linalg.vector_norm(body_forces[:, self.termination_ix], dim=-1)
        reset_buf = torch.any(term_force > 1.0, dim=1)
        reach_goal_cutoff = cur_goal_idx >= (self.n_goals_total - self.last_goal_repeat)
        time_out = (episode_length > self.max_episode_length) | reach_goal_cutoff
        reset_buf = (reset_buf | time_out | (torch.abs(roll) > 1.5) | (torch.abs(pitch) > 1.5)
                     | (sim.base_pos[:, 2] < -0.25) | leave)

        rew, terms = self._compute_reward(dict(
            sim=sim, yaw=yaw, target_yaw=target_yaw, target_rel=target_rel,
            cur_obst_type=cur_obst_type, reached=reached, body_forces=body_forces,
            contact_filt=contact_filt, hl_hist=state.action_hl_history,
            reset_buf=reset_buf, time_out=time_out))
        episode_sums = state.episode_sums + terms

        # --- terminal disc obs of the pre-reset state; root height over the
        # full-grid floor at the centre scan point (pre-step weights)
        center_pt = qm.quat_apply_yaw(bq, self.height_points[:, self.center_height_idx]) \
            + sim.base_pos
        ch = hf.sample_height_min3(self.grid, center_pt[:, 0], center_pt[:, 1],
                                   self._weights(state))
        root_h = sim.base_pos[:, 2] - ch
        terminal_disc_obs = compute_disc_features(self.mc, self.feet_idx, cfg.obs_scales, sim,
                                                  contact_filt, root_h[:, None])

        # success-rate EMAs over ending episodes, and the from-station-0
        # traversal metrics
        def ema(old, n, k):
            return torch.where(n > 0, old * 0.98 + 0.02 * (k / torch.clamp(n, min=1)), old)

        # counts over ending episodes (exact integers in float32), summed
        # over every rank's envs: the EMAs and the curriculum stay alike
        end_s0 = reset_buf & (state.spawn_goal_idx == 0)
        counts = torch.stack([
            reset_buf.sum(), (reach_goal_cutoff & reset_buf).sum(), end_s0.sum(),
            (reach_goal_cutoff & end_s0).sum()]).float()
        prog = torch.sum(torch.where(reset_buf, (cur_goal_idx - state.spawn_goal_idx).float(), 0.0))
        counts = torch.cat([counts, prog[None]])
        if self.shard is not None:
            mesh.all_reduce_(counts)
        n_end, k_end, n_s0, k_s0, prog = counts
        success_rate = ema(state.success_rate, n_end, k_end)
        success_rate_s0 = ema(state.success_rate_s0, n_s0, k_s0)
        goal_progress = ema(state.goal_progress, n_end, prog)

        curr_count = state.curr_count
        if cfg.obstacle.curriculum and global_counter % (self.max_episode_length * 2) == 0:
            curr_count = curr_count + (success_rate > cfg.obstacle.curr_threshold).long()

        mid = state._replace(
            sim=sim, seesaw_theta=seesaw_theta, seesaw_theta_d=seesaw_theta_d,
            episode_length=episode_length, global_counter=global_counter, actions_bbc=acts,
            action_history=action_history, torques_org=tau_org, last_contacts=contact,
            contact_filt=contact_filt, cur_goal_idx=cur_goal_idx,
            reach_goal_timer=reach_goal_timer, target_yaw=target_yaw,
            next_target_yaw=next_target_yaw, leave_goal=leave, reached_goal=reached,
            curr_count=curr_count, success_rate=success_rate, success_rate_s0=success_rate_s0,
            goal_progress=goal_progress, episode_sums=episode_sums, reset_buf=reset_buf,
            time_out_buf=time_out, reach_goal_cutoff=reach_goal_cutoff)
        mid = self._reset_where(mid, reset_buf)
        mid = mid._replace(cur_goals=self._gather_goals(mid, mid.cur_goal_idx),
                           next_goals=self._gather_goals(mid, mid.cur_goal_idx + 1))

        obs, obs_bbc, disc_obs, obs_history, dyaw, dnyaw = self._compute_observations(mid)
        new_state = mid._replace(
            obs_buf=obs, obs_bbc_buf=obs_bbc, disc_obs=disc_obs, obs_history=obs_history,
            delta_yaw=dyaw, delta_next_yaw=dnyaw, last_actions_bbc=mid.actions_bbc,
            last_dof_vel=mid.sim.u[:, 6:], last_torques_org=mid.torques_org)
        out = TscStepOutput(
            obs=obs, obs_bbc=obs_bbc, rew=rew, reset=reset_buf, time_out=time_out,
            reach_goal_cutoff=reach_goal_cutoff, disc_obs=disc_obs,
            terminal_disc_obs=terminal_disc_obs, episode_sums=episode_sums, reward_terms=terms)
        return new_state, out

    # ------------------------------------------------------------------

    def _obstacle_type(self, goal_idx):
        """Obstacle type of the station the goal index belongs to."""
        g = torch.clamp(goal_idx, 0, self.n_goals_total - self.last_goal_repeat - 1)
        return torch.gather(self.obst_types, 1, (g // self.num_goals)[:, None])[:, 0]

    @trace.spanned("env.reset")
    def _reset_where(self, state: AgilityState, mask,
                     draws: Optional[ResetDraws] = None) -> AgilityState:
        """Masked reset: envs where `mask` get a fresh start pose at their
        course's start (or, with randomize_start, a random station), fresh
        obstacle heights and zeroed buffers.  `draws` defaults to a fresh
        draw_reset()."""
        N, e = self.num_envs, self.cfg.env
        if draws is None:
            draws = self.draw_reset()
        dx = draws.dx * e.randomize_start_x
        dy = draws.dy * e.randomize_start_y
        dyaw = draws.dyaw * e.randomize_start_yaw
        z0 = torch.full((N,), self.cfg.init_state.pos[2], device=self.device)
        if e.randomize_start:
            # spawn at a random station's approach goal, with its heading
            obst_idx = draws.obst_idx
            goal_idx = obst_idx * self.cfg.obstacle.num_goals
            ar = torch.arange(N, device=self.device)
            spawn = self.env_goals[ar, goal_idx]
            yaw0 = self.obst_yaws[ar, obst_idx] + dyaw
            base_pos = torch.stack([spawn[:, 0] + dx, spawn[:, 1] + dy, z0], dim=-1)
        else:
            goal_idx = torch.zeros(N, dtype=torch.long, device=self.device)
            yaw0 = torch.pi / 2 + dyaw             # the first station runs along +y
            base_pos = self.robot_org + torch.stack([dx, dy, z0], dim=-1)
        zero_n = torch.zeros(N, device=self.device)
        base_quat = qm.quat_from_euler_xyz(zero_n, zero_n, yaw0)
        dof_pos = self.mc.default_dof_pos * draws.dof_scale
        lin_ang = draws.lin_ang * e.randomize_start_vel
        u_new = torch.cat([lin_ang, torch.zeros((N, 12), device=self.device)], dim=-1)

        m1 = mask[:, None]
        sim = eng.EnvState(
            base_pos=torch.where(m1, base_pos, state.sim.base_pos),
            base_quat=torch.where(m1, base_quat, state.sim.base_quat),
            dof_pos=torch.where(m1, dof_pos, state.sim.dof_pos),
            u=torch.where(m1, u_new, state.sim.u))
        zero = lambda x: torch.where(mask.reshape((N,) + (1,) * (x.dim() - 1)),
                                     torch.zeros_like(x), x)
        bar_h, tire_h = self._sample_heights_where(state, mask, draws)
        return state._replace(
            sim=sim, bar_h=bar_h, tire_h=tire_h,
            seesaw_theta=torch.where(mask, obst_gen.SEESAW_THETA_REST, state.seesaw_theta),
            seesaw_theta_d=zero(state.seesaw_theta_d),
            episode_length=zero(state.episode_length),
            actions_bbc=zero(state.actions_bbc), last_actions_bbc=zero(state.last_actions_bbc),
            action_history=zero(state.action_history),
            action_hl_history=zero(state.action_hl_history),
            last_dof_vel=zero(state.last_dof_vel), torques_org=zero(state.torques_org),
            last_torques_org=zero(state.last_torques_org), obs_history=zero(state.obs_history),
            cur_goal_idx=torch.where(mask, goal_idx, state.cur_goal_idx),
            spawn_goal_idx=torch.where(mask, goal_idx, state.spawn_goal_idx),
            reach_goal_timer=zero(state.reach_goal_timer),
            episode_sums=zero(state.episode_sums))

    # ------------------------------------------------------------------

    @trace.spanned("env.scandots")
    def _measure_heights(self, state, base_pos, base_quat):
        """Scandot floor heights (N, 132) through K3: the window is centred on
        the yaw-rotated scan-grid centre and sized to its radius, so every
        scandot stays inside it."""
        pts = qm.quat_apply_yaw(base_quat[:, None, :], self.height_points) + base_pos[:, None, :]
        centers = (qm.quat_apply_yaw(base_quat, self.scan_center_local) + base_pos)[:, :2]
        return scandots(self.grid, centers.contiguous(), self.scan_size, self._weights(state),
                        pts[..., 0].contiguous(), pts[..., 1].contiguous())

    @trace.spanned("env.obs")
    def _compute_observations(self, state: AgilityState):
        cfg = self.cfg
        osc = cfg.obs_scales
        sim = state.sim
        bq = sim.base_quat
        base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])
        base_ang_vel = qm.quat_rotate_inverse(bq, sim.u[:, 3:6])
        roll, pitch, yaw = qm.euler_from_quat(bq)
        measured = self._measure_heights(state, sim.base_pos, bq)
        root_h = (sim.base_pos[:, 2] - measured[:, self.center_height_idx])[:, None]
        delta_yaw = qm.wrap_to_pi(state.target_yaw - yaw)
        delta_next_yaw = qm.wrap_to_pi(state.next_target_yaw - yaw)
        cf = state.contact_filt.to(bq.dtype)
        disc_obs = compute_disc_features(self.mc, self.feet_idx, osc, sim, state.contact_filt,
                                         root_h)
        prop = torch.cat([torch.stack([roll, pitch], -1), base_ang_vel * osc.ang_vel,
                          (sim.dof_pos - self.mc.default_dof_pos) * osc.dof_pos,
                          sim.u[:, 6:] * osc.dof_vel, state.action_history[:, -1], cf - 0.5,
                          torch.zeros((self.num_envs, 12), device=self.device)], dim=-1)
        root_h_obs = root_h if cfg.env.root_height_obs else torch.zeros_like(root_h)
        priv_explicit = torch.cat([root_h_obs, base_lin_vel * osc.lin_vel], -1)
        priv_latent = torch.cat([self.mass_params, self.base_params.friction[:, None],
                                 self.base_params.kp_scale - 1.0,
                                 self.base_params.kd_scale - 1.0], -1)
        obst_onehot = torch.nn.functional.one_hot(
            self._obstacle_type(state.cur_goal_idx), cfg.env.n_obst_type).to(bq.dtype)
        heights = torch.clamp(sim.base_pos[:, 2:3] - 0.3 - measured, -1.0, 1.0)
        obs_history = torch.where(
            (state.episode_length <= 1)[:, None, None],
            prop[:, None, :].expand(-1, cfg.env.history_len, -1),
            torch.cat([state.obs_history[:, 1:], prop[:, None, :]], dim=1))
        hist_flat = obs_history.reshape(self.num_envs, -1)
        obs = torch.cat([prop, torch.stack([delta_yaw, delta_next_yaw], -1), obst_onehot,
                         heights, priv_explicit, priv_latent, hist_flat], dim=-1)
        obs_bbc = torch.cat([prop, priv_explicit, priv_latent, hist_flat, state.commands,
                             state.latent_eps, state.latent_c], dim=-1)
        clip = cfg.clip_observations
        return (torch.clamp(obs, -clip, clip), torch.clamp(obs_bbc, -clip, clip), disc_obs,
                torch.clamp(obs_history, -clip, clip), delta_yaw, delta_next_yaw)

    # ------------------------------------------------------------------

    @trace.spanned("env.reward")
    def _compute_reward(self, q):
        """Parkour reward terms (scales pre-multiplied by dt, zero-scale terms
        pruned) plus the termination penalty after the positive clip."""
        cfg = self.cfg.rewards
        terms = {}
        target_rel = q["target_rel"]
        tvn = target_rel / (torch.linalg.vector_norm(target_rel, dim=-1, keepdim=True) + 1e-5)
        proj = torch.sum(tvn * q["sim"].u[:, :2], dim=-1)
        # jump obstacles (bar = 0, tire = 4) push the target speed to 2.5 m/s
        jump_obst = (q["cur_obst_type"] == 0) | (q["cur_obst_type"] == 4)
        tgt = torch.where(jump_obst, 2.5, cfg.target_lin_vel)
        terms["tracking_goal_vel"] = torch.minimum(proj, tgt) / (tgt + 1e-5)
        terms["tracking_yaw"] = torch.exp(-torch.abs(qm.wrap_to_pi(q["target_yaw"] - q["yaw"])))
        terms["reach_goal"] = q["reached"].float()
        pen = torch.linalg.vector_norm(q["body_forces"][:, self.penalized_ix], dim=-1)
        terms["collision"] = torch.sum((pen > 0.1).float(), -1)
        hl = q["hl_hist"]
        terms["action_hl_rate"] = torch.linalg.vector_norm(hl[:, -2] - hl[:, -1], dim=-1)
        terms["latent_c_rate"] = 0.5 * (torch.abs(hl[:, -3, 0] - hl[:, -1, 0])
                                        + torch.abs(hl[:, -2, 0] - hl[:, -1, 0]))
        # feet on x-edge cells while in contact
        feet = soa.body_positions(self.mc, q["sim"], self.feet_idx)
        gx, gy = pt.grid_index(self.grid, feet[..., 0], feet[..., 1])
        H, W = self.x_edge.shape
        at_edge = self.x_edge[torch.clamp(torch.round(gx).long(), 0, H - 1),
                              torch.clamp(torch.round(gy).long(), 0, W - 1)]
        terms["feet_edge"] = torch.sum((q["contact_filt"] & at_edge).float(), -1)

        scaled = torch.stack([terms[n] for n in self.reward_names], dim=-1) * self.reward_scales
        total = torch.sum(scaled, dim=-1)
        if cfg.only_positive_rewards:
            total = torch.clamp(total, min=0.0)
        if self.termination_scale:
            term_rew = (q["reset_buf"] & ~q["time_out"]).float() * self.termination_scale
            total = total + term_rew
            scaled = torch.cat([scaled, term_rew[:, None]], dim=-1)
        return total, scaled
