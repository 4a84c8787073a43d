"""Go2 locomotion environment, the BBC task (counterpart of
agility_tpu/envs/go2_locomotion.py).

The env holds static data (model constants, terrain grid, domain-
randomization draws, reward tables) on one device; `step` maps
(LocoState, actions) -> (LocoState, StepOutput) with masked resets, as in
the JAX package.  All random draws of init/step/reset go through one
`torch.Generator` kept on the env (the JAX package threads a PRNG key in
the state instead, so the two give different random streams).

Observation layout:
  actor/priv obs (671) = [prop 57 | explicit 4 | priv latent 29 |
                          prop history 10x57 | commands 5 | eps 1 | c 5]
  disc obs (49) = [roll,pitch | root_h | lin_vel*0.5 | ang_vel*0.25 |
                   dof_pos-default | dof_vel*0.05 | flat key pos | contact]
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from agility_tpu_torch.core import quat as qm
from agility_tpu_torch.core.urdf import build_go2_model
from agility_tpu_torch.dist.mesh import EnvShard
from agility_tpu_torch.envs import mocap as mocap_mod
from agility_tpu_torch.envs.config import Go2LocomotionCfg
from agility_tpu_torch.physics import engine as eng
from agility_tpu_torch.physics import heightfield as hf
from agility_tpu_torch.physics import soa
from agility_tpu_torch.physics.constants import ModelConsts
from agility_tpu_torch.terrain import generator as terrain_gen


class LocoState(NamedTuple):
    sim: eng.EnvState                 # batched (N, ...) leaves
    episode_length: torch.Tensor      # (N,) int64
    commands: torch.Tensor            # (N, 5)
    latent_eps: torch.Tensor          # (N, 1)
    latent_c: torch.Tensor            # (N, C)
    prior_parameters: torch.Tensor    # (C,)
    actions: torch.Tensor             # (N, 12) clipped delayed actions
    last_actions: torch.Tensor        # (N, 12)
    action_history: torch.Tensor      # (N, buf_len, 12)
    last_dof_vel: torch.Tensor        # (N, 12)
    torques_org: torch.Tensor         # (N, 12)
    last_torques_org: torch.Tensor    # (N, 12)
    obs_history: torch.Tensor         # (N, hist, 57)
    last_contacts: torch.Tensor       # (N, 4) bool
    contact_filt: torch.Tensor        # (N, 4) bool
    feet_air_time: torch.Tensor       # (N, 4)
    episode_sums: torch.Tensor        # (N, n_rew)
    reset_buf: torch.Tensor           # (N,) bool
    time_out_buf: torch.Tensor        # (N,) bool
    global_counter: int               # control steps taken (same for all envs)
    obs_buf: torch.Tensor             # (N, 671)
    disc_obs: torch.Tensor            # (N, 49)


class StepOutput(NamedTuple):
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    rew: torch.Tensor
    reset: torch.Tensor
    time_out: torch.Tensor
    disc_obs: torch.Tensor            # post-step (fresh state)
    terminal_disc_obs: torch.Tensor   # pre-reset disc obs
    episode_sums: torch.Tensor
    reward_terms: torch.Tensor


def state_from_jax(js, device="cuda") -> LocoState:
    """A LocoState from the JAX package's LocoState (or any object with the
    same field names), leaf by leaf through numpy; the JAX PRNG key is
    dropped.  Lets a test start both envs from one state."""
    t = lambda x: torch.as_tensor(np.array(x), device=device)
    fields = {k: t(getattr(js, k)) for k in LocoState._fields
              if k not in ("sim", "global_counter")}
    fields["episode_length"] = fields["episode_length"].long()
    sim = eng.EnvState(*(t(getattr(js.sim, k)) for k in eng.EnvState._fields))
    return LocoState(sim=sim, global_counter=int(js.global_counter), **fields)


def compute_disc_features(mc, feet_idx, osc, sim, contact_filt, root_h):
    """49-d discriminator features of a (possibly pre-reset) sim state."""
    bq = sim.base_quat
    base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])
    base_ang_vel = qm.quat_rotate_inverse(bq, sim.u[:, 3:6])
    roll, pitch, _ = qm.euler_from_quat(bq)
    key_pos_w = soa.body_positions(mc, sim, feet_idx)
    flat_key_pos = qm.quat_rotate(qm.heading_quat_inv(bq)[:, None, :],
                                  key_pos_w - sim.base_pos[:, None, :]).reshape(bq.shape[0], -1)
    return torch.cat(
        [torch.stack([roll, pitch], -1), root_h, base_lin_vel * osc.lin_vel_dist,
         base_ang_vel * osc.ang_vel_dist, (sim.dof_pos - mc.default_dof_pos) * osc.dof_pos,
         sim.u[:, 6:] * osc.dof_vel, flat_key_pos * osc.key_pos,
         contact_filt.to(bq.dtype) * osc.foot_contact], dim=-1)


class Go2LocomotionEnv:
    """Static env data on `device` + step/reset functions."""

    def __init__(self, cfg: Go2LocomotionCfg, device="cuda", seed: int = 0,
                 motion: Optional[mocap_mod.MotionData] = None,
                 shard: Optional[EnvShard] = None):
        """`shard`: this rank's block of the cfg.env.num_envs global envs
        (dist/mesh.py); the env then holds and steps those envs alone, and
        every per-env draw and per-env constant is the one-rank env's, the
        rank's rows taken."""
        if cfg.env.recovery_init_prob > 0.0:
            raise NotImplementedError("recovery init is not ported (off in the go2 task)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = build_go2_model()
        self.mc = ModelConsts.from_model(self.model, self.device)
        self.dt = cfg.dt
        self.shard = shard
        self.num_envs_global = N = cfg.env.num_envs
        self.num_envs = shard.local if shard else N
        self.dim_c = len(cfg.env.mocap_category_all)
        self.num_mocap = len(cfg.env.mocap_category)
        self.single_c_idx = (list(cfg.env.mocap_category_all).index(cfg.env.mocap_category[0])
                             if self.num_mocap == 1 else -1)
        self.engine_cfg = eng.EngineConfig(
            dt=cfg.sim.dt, decimation=cfg.control.decimation, gravity=cfg.sim.gravity,
            jacobi_iters=cfg.sim.jacobi_iters, jacobi_relax=cfg.sim.jacobi_relax,
            warm_start=cfg.sim.warm_start, restitution=cfg.terrain.restitution)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        # per-env constants: drawn for all N global envs, the rank's rows kept
        f32e = lambda x: f32(shard.take(np.asarray(x)) if shard else x)

        td = terrain_gen.generate(cfg.terrain, seed=cfg.seed)
        self.grid = hf.from_numpy(td.height, td.hscale, origin_xy=td.origin, device=self.device)
        self.env_origins = f32e(terrain_gen.assign_env_origins(td, N, cfg.terrain, seed=cfg.seed))
        if motion is not None:
            self.motion = motion
        elif cfg.mocap_dir:
            # a missing mocap_all_ulb globs empty: no unlabelled set
            self.motion = mocap_mod.load_dir(
                os.path.join(cfg.mocap_dir, "mocap_all_lb"),
                os.path.join(cfg.mocap_dir, "mocap_all_ulb"),
                cfg.env.mocap_category_all, self.device)
        else:
            self.motion = mocap_mod.synthetic(
                self.model, cfg.env.mocap_category_all, active=cfg.env.mocap_category,
                device=self.device)

        m = self.model
        self.feet_idx = m.match_bodies("foot")
        self.penalized_idx = m.match_bodies("thigh") + m.match_bodies("calf")
        self.termination_idx = m.match_bodies("base") + m.match_bodies("hip")
        self.hip_dofs = [0, 3, 6, 9]
        mid = (m.dof_limit_lower + m.dof_limit_upper) / 2
        r = m.dof_limit_upper - m.dof_limit_lower
        soft = cfg.rewards.soft_dof_pos_limit
        self.soft_dof_lower = f32(mid - 0.5 * r * soft)
        self.soft_dof_upper = f32(mid + 0.5 * r * soft)
        self.dof_vel_limit = f32(m.dof_velocity_limit)
        self.dof_effort_limit = f32(m.dof_effort_limit)

        # per-env domain randomization: the same numpy draws as the JAX env
        rng = np.random.default_rng(cfg.seed)
        dr = cfg.domain_rand
        if dr.randomize_friction:
            friction = rng.uniform(*dr.friction_range, size=64)[rng.integers(0, 64, N)]
        else:
            friction = np.ones(N)
        added_mass = (rng.uniform(*dr.added_mass_range, N) if dr.randomize_base_mass
                      else np.zeros(N))
        com_shift = (rng.uniform(*dr.added_com_range, (N, 3)) if dr.randomize_base_com
                     else np.zeros((N, 3)))
        if dr.randomize_motor and dr.use_easi:
            mean, var = np.asarray(dr.easi_mean), np.asarray(dr.easi_var)
            ti = np.array([0, 2, 4] * 4)      # per-dof EASI index: hip, thigh, calf
            kp_scale = rng.normal(mean[ti], np.sqrt(var[ti]), (N, 12))
            kd_scale = rng.normal(mean[ti + 1], np.sqrt(var[ti + 1]), (N, 12))
        elif dr.randomize_motor:
            kp_scale = rng.uniform(*dr.motor_strength_range, (N, 12))
            kd_scale = rng.uniform(*dr.motor_strength_range, (N, 12))
        else:
            kp_scale = kd_scale = np.ones((N, 12))
        self.params = eng.EnvParams(friction=f32e(friction), kp_scale=f32e(kp_scale),
                                    kd_scale=f32e(kd_scale), added_base_mass=f32e(added_mass),
                                    base_com_shift=f32e(com_shift))
        self.mass_params = f32e(np.concatenate([added_mass[:, None], com_shift], -1))
        n = self.num_envs
        self.kp = torch.full((n, 12), cfg.control.stiffness, device=self.device)
        self.kd = torch.full((n, 12), cfg.control.damping, device=self.device)
        hip = np.ones(12)
        hip[self.hip_dofs] = cfg.control.hip_scale_reduction
        self.hip_scale = f32(hip)

        t = cfg.terrain
        gx, gy = np.meshgrid(t.measured_points_x, t.measured_points_y, indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
        self.center_point = f32(pts[gx.size // 2 + 1])

        scales = dataclasses.asdict(cfg.rewards.scales)
        self.reward_names = [k for k, v in scales.items() if v != 0 and k != "termination"]
        self.reward_scales = f32([scales[k] * self.dt for k in self.reward_names])
        self.n_rew = len(self.reward_names)

        ns, osc, lvl = cfg.noise.scales, cfg.normalization.obs_scales, cfg.noise.noise_level
        nv = np.zeros(cfg.env.num_actor_obs, np.float32)
        nv[0:2] = ns.roll_pitch * lvl
        nv[2:5] = ns.ang_vel * lvl * osc.ang_vel
        nv[5:17] = ns.dof_pos * lvl * osc.dof_pos
        nv[17:29] = ns.dof_vel * lvl * osc.dof_vel
        nv[58:61] = ns.lin_vel * lvl * osc.lin_vel
        self.noise_vec = f32(nv)

        cr = cfg.commands.ranges
        self.cmd_ranges = {k: f32(getattr(cr, k)) for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw")}
        self.resample_steps = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.max_episode_length = cfg.max_episode_length

    def _rand(self, *shape, env_axis: int = 0):
        """U[0, 1) draws of `shape`, whose `env_axis` runs over this env's
        envs: drawn at the global width and the rank's envs taken."""
        if self.shard is None:
            return torch.rand(shape, generator=self.gen, device=self.device)
        full = shape[:env_axis] + (self.num_envs_global,) + shape[env_axis + 1:]
        return self.shard.take(torch.rand(full, generator=self.gen, device=self.device),
                               env_axis)

    # ==================================================================

    def init_state(self) -> LocoState:
        N, C, H = self.num_envs, self.dim_c, self.cfg.env.history_len
        z = lambda *s: torch.zeros(s, device=self.device)
        latent_c = z(N, C)
        latent_c[:, 0] = 1.0
        quat = z(N, 4)
        quat[:, 3] = 1.0
        s = LocoState(
            sim=eng.EnvState(base_pos=z(N, 3), base_quat=quat,
                             dof_pos=self.mc.default_dof_pos.repeat(N, 1), u=z(N, 18)),
            episode_length=torch.zeros(N, dtype=torch.long, device=self.device),
            commands=z(N, 5), latent_eps=z(N, 1), latent_c=latent_c,
            prior_parameters=torch.full((C,), 1.0 / C, device=self.device),
            actions=z(N, 12), last_actions=z(N, 12),
            action_history=z(N, self.cfg.domain_rand.action_buf_len, 12),
            last_dof_vel=z(N, 12), torques_org=z(N, 12), last_torques_org=z(N, 12),
            obs_history=z(N, H, self.cfg.env.num_prop),
            last_contacts=torch.zeros((N, 4), dtype=torch.bool, device=self.device),
            contact_filt=torch.zeros((N, 4), dtype=torch.bool, device=self.device),
            feet_air_time=z(N, 4), episode_sums=z(N, self.n_rew),
            reset_buf=torch.zeros(N, dtype=torch.bool, device=self.device),
            time_out_buf=torch.zeros(N, dtype=torch.bool, device=self.device),
            global_counter=0, obs_buf=z(N, self.cfg.env.num_actor_obs),
            disc_obs=z(N, self.cfg.env.num_obs_disc))
        s = self._reset_where(s, torch.ones(N, dtype=torch.bool, device=self.device))
        # fill the caches with a zero-action step
        s, _ = self.step(s, z(N, 12))
        return s

    # ==================================================================

    def step(self, state: LocoState, actions: torch.Tensor) -> Tuple[LocoState, StepOutput]:
        cfg = self.cfg
        dr = cfg.domain_rand

        # --- action pipeline: delay buffer, clip, scale ---
        action_history = torch.cat([state.action_history[:, 1:], actions[:, None, :]], dim=1)
        if dr.action_delay and len(dr.action_curr_step) > 1:
            delay = dr.action_curr_step[int(state.global_counter >= dr.delay_update_global_steps)]
            used = action_history[:, action_history.shape[1] - 1 - delay]
        else:
            used = actions
        clip_a = cfg.normalization.clip_actions / cfg.control.action_scale
        acts = torch.clamp(used, -clip_a, clip_a)
        target = acts * cfg.control.action_scale * self.hip_scale + self.mc.default_dof_pos
        control = eng.Control(target=target, kp=self.kp, kd=self.kd)

        # --- physics ---
        sim, (tau, tau_org), body_forces, _, _ = eng.step_batch(
            self.mc, self.engine_cfg, self.grid, state.sim, control, self.params)

        episode_length = state.episode_length + 1
        global_counter = state.global_counter + 1

        bq = sim.base_quat
        base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])
        base_ang_vel = qm.quat_rotate_inverse(bq, sim.u[:, 3:6])
        contact = torch.linalg.vector_norm(body_forces[:, self.feet_idx], dim=-1) > 2.0
        contact_filt = contact | state.last_contacts

        resample = (episode_length % self.resample_steps) == 0
        latent_eps, latent_c, commands = self._resample_where(state, resample)

        if dr.push_robots and global_counter % self.push_interval == 0:
            push = (self._rand(self.num_envs, 2) * 2.0 - 1.0) * dr.max_push_vel_xy
            sim = sim._replace(u=torch.cat([push, sim.u[:, 2:]], dim=1))
            base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])

        term_force = torch.linalg.vector_norm(body_forces[:, self.termination_idx], dim=-1)
        reset_buf = torch.any(term_force > 1.0, dim=1)
        time_out = (episode_length > self.max_episode_length) | (sim.base_pos[:, 2] < -6.0)
        reset_buf = reset_buf | time_out

        root_h = self._center_root_height(sim.base_pos, bq)
        rew, terms = self._compute_reward(dict(
            base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel, commands=commands,
            torques_org=tau_org, last_torques_org=state.last_torques_org,
            dof_vel=sim.u[:, 6:], last_dof_vel=state.last_dof_vel, dof_pos=sim.dof_pos,
            actions=acts, last_actions=state.last_actions, body_forces=body_forces,
            root_h=root_h))
        episode_sums = state.episode_sums + terms

        terminal_disc_obs = compute_disc_features(
            self.mc, self.feet_idx, cfg.normalization.obs_scales, sim, contact_filt,
            root_h[:, None])

        mid = state._replace(
            sim=sim, episode_length=episode_length, commands=commands,
            latent_eps=latent_eps, latent_c=latent_c, actions=acts,
            action_history=action_history, torques_org=tau_org, last_contacts=contact,
            contact_filt=contact_filt, episode_sums=episode_sums, reset_buf=reset_buf,
            time_out_buf=time_out, global_counter=global_counter)
        mid = self._reset_where(mid, reset_buf)
        obs, priv_obs, disc_obs, obs_history = self._compute_observations(mid)

        new_state = mid._replace(
            obs_buf=obs, disc_obs=disc_obs, obs_history=obs_history,
            last_actions=mid.actions, last_dof_vel=mid.sim.u[:, 6:],
            last_torques_org=mid.torques_org)
        out = StepOutput(obs=obs, privileged_obs=priv_obs, rew=rew, reset=reset_buf,
                         time_out=time_out, disc_obs=disc_obs,
                         terminal_disc_obs=terminal_disc_obs, episode_sums=episode_sums,
                         reward_terms=terms)
        return new_state, out

    # ==================================================================

    def _center_root_height(self, base_pos, base_quat):
        """Root height over the terrain at the centre measurement point."""
        if not self.cfg.terrain.measure_heights:
            return base_pos[:, 2]
        pt = qm.quat_apply_yaw(base_quat, self.center_point.expand(base_pos.shape[0], 3)) + base_pos
        return base_pos[:, 2] - hf.sample_height_min3(self.grid, pt[:, 0], pt[:, 1])

    def _resample_where(self, state: LocoState, mask):
        """Draw new eps / c / commands for all envs, keep them where `mask`."""
        N = self.num_envs
        eps_new = self._rand(N, 1) * 2.0 - 1.0
        if self.num_mocap == 1:
            cat = torch.full((N,), self.single_c_idx, dtype=torch.long, device=self.device)
        else:
            prior = torch.softmax(state.prior_parameters / 0.25, dim=-1)
            cat = mocap_mod.categorical(self.gen, prior.expand(N, -1), self.shard)
        c_new = torch.nn.functional.one_hot(cat, self.dim_c).to(eps_new.dtype)
        cmd_new = self._sample_commands(c_new)
        m1 = mask[:, None]
        return (torch.where(m1, eps_new, state.latent_eps),
                torch.where(m1, c_new, state.latent_c),
                torch.where(m1, cmd_new, state.commands))

    def _sample_commands(self, latent_c):
        """Per-mode command ranges."""
        cfg = self.cfg.commands
        N = self.num_envs
        c_idx = torch.argmax(latent_c, dim=-1)
        u = self._rand(5, N, env_axis=1)
        rx, ry, rw = (self.cmd_ranges[k][c_idx] for k in ("lin_vel_x", "lin_vel_y", "ang_vel_yaw"))
        vx = rx[:, 0] + (rx[:, 1] - rx[:, 0]) * u[0]
        vy = ry[:, 0] + (ry[:, 1] - ry[:, 0]) * u[1]
        wz = rw[:, 0] + (rw[:, 1] - rw[:, 0]) * u[2]
        if self.num_mocap == 1:
            jump_cmd = torch.full((N,), self.cfg.env.mocap_category[0] == "jump",
                                  device=self.device)
        else:
            jump_cmd = c_idx == (self.dim_c - 1)
        jh, lh = cfg.ranges.jump_height, cfg.ranges.locomotion_height
        jump_h = (jh[0] + (jh[1] - jh[0]) * u[3]) * jump_cmd
        loco_h = (lh[0] + (lh[1] - lh[0]) * u[4]) * (~jump_cmd)
        vx = vx * (torch.abs(vx) > cfg.lin_vel_x_clip)
        vy = vy * (torch.abs(vy) > cfg.lin_vel_y_clip)
        wz = wz * (torch.abs(wz) > cfg.ang_vel_yaw_clip)
        return torch.stack([vx, vy, wz, jump_h, loco_h], dim=-1)

    def _reset_where(self, state: LocoState, mask) -> LocoState:
        """Masked reset: envs where `mask` get a fresh mocap (or default) pose,
        latents and commands, and zeroed buffers."""
        N = self.num_envs
        latent_eps, latent_c, commands = self._resample_where(state, mask)
        if self.cfg.env.mocap_state_init:
            frames = self.motion.sample_frames(self.gen, torch.argmax(latent_c, dim=-1), self.dt,
                                               shard=self.shard)
            dof_pos = frames[:, mocap_mod.JOINT_POS]
            dof_vel = frames[:, mocap_mod.JOINT_VEL]
            base_xy = frames[:, mocap_mod.ROOT_POS][:, :2] + self.env_origins[:, :2]
            # mocap z is height above flat ground: lift by the terrain height
            # at the spawn xy
            h = hf.sample_height(self.grid, base_xy[:, 0], base_xy[:, 1])
            base_pos = torch.cat([base_xy, (frames[:, 2] + h)[:, None]], dim=-1)
            base_quat = frames[:, mocap_mod.ROOT_ROT]
            lin = qm.quat_rotate(base_quat, frames[:, mocap_mod.LIN_VEL])
            ang = qm.quat_rotate(base_quat, frames[:, mocap_mod.ANG_VEL])
        else:
            dof_pos = self.mc.default_dof_pos * (0.5 + self._rand(N, 12))
            dof_vel = torch.zeros((N, 12), device=self.device)
            base_pos = torch.tensor(self.cfg.init_state.pos, device=self.device) + self.env_origins
            base_quat = torch.tensor(self.cfg.init_state.rot, device=self.device).expand(N, 4)
            lin_ang = self._rand(N, 6) - 0.5
            lin, ang = lin_ang[:, :3], lin_ang[:, 3:]
        m1 = mask[:, None]
        sim = eng.EnvState(
            base_pos=torch.where(m1, base_pos, state.sim.base_pos),
            base_quat=torch.where(m1, base_quat, state.sim.base_quat),
            dof_pos=torch.where(m1, dof_pos, state.sim.dof_pos),
            u=torch.where(m1, torch.cat([lin, ang, dof_vel], dim=-1), state.sim.u))
        zero = lambda x: torch.where(mask.reshape((N,) + (1,) * (x.dim() - 1)),
                                     torch.zeros_like(x), x)
        return state._replace(
            sim=sim, commands=commands, latent_eps=latent_eps, latent_c=latent_c,
            episode_length=torch.where(mask, 0, state.episode_length),
            actions=zero(state.actions), last_actions=zero(state.last_actions),
            action_history=zero(state.action_history), last_dof_vel=zero(state.last_dof_vel),
            torques_org=zero(state.torques_org), last_torques_org=zero(state.last_torques_org),
            obs_history=zero(state.obs_history), feet_air_time=zero(state.feet_air_time),
            episode_sums=zero(state.episode_sums))

    # ------------------------------------------------------------------

    def _compute_observations(self, state: LocoState):
        cfg = self.cfg
        osc = cfg.normalization.obs_scales
        sim = state.sim
        bq = sim.base_quat
        base_lin_vel = qm.quat_rotate_inverse(bq, sim.u[:, :3])
        base_ang_vel = qm.quat_rotate_inverse(bq, sim.u[:, 3:6])
        roll, pitch, _ = qm.euler_from_quat(bq)
        root_h = self._center_root_height(sim.base_pos, bq)[:, None]
        cf = state.contact_filt.to(bq.dtype)
        disc_obs = compute_disc_features(self.mc, self.feet_idx, osc, sim,
                                         state.contact_filt, root_h)
        # prop's key-pos block is zeroed, as in the reference
        prop = torch.cat([torch.stack([roll, pitch], -1), base_ang_vel * osc.ang_vel,
                          (sim.dof_pos - self.mc.default_dof_pos) * osc.dof_pos,
                          sim.u[:, 6:] * osc.dof_vel, state.action_history[:, -1], cf - 0.5,
                          torch.zeros((self.num_envs, 12), device=self.device)], dim=-1)
        root_h_obs = root_h if cfg.env.root_height_obs else torch.zeros_like(root_h)
        priv_explicit = torch.cat([root_h_obs, base_lin_vel * osc.lin_vel], -1)
        priv_latent = torch.cat([self.mass_params, self.params.friction[:, None],
                                 self.params.kp_scale - 1.0, self.params.kd_scale - 1.0], -1)
        # history ring, seeded with the current prop obs on fresh episodes
        obs_history = torch.where(
            (state.episode_length <= 1)[:, None, None],
            prop[:, None, :].expand(-1, cfg.env.history_len, -1),
            torch.cat([state.obs_history[:, 1:], prop[:, None, :]], dim=1))
        priv_obs = torch.cat([prop, priv_explicit, priv_latent,
                              obs_history.reshape(self.num_envs, -1), state.commands,
                              state.latent_eps, state.latent_c], dim=-1)
        if cfg.noise.add_noise:
            priv_obs = priv_obs + (self._rand(*priv_obs.shape) * 2.0 - 1.0) * self.noise_vec
        clip = cfg.normalization.clip_observations
        priv_obs = torch.clamp(priv_obs, -clip, clip)
        return priv_obs, priv_obs, disc_obs, torch.clamp(obs_history, -clip, clip)

    # ------------------------------------------------------------------

    def _compute_reward(self, q):
        """Active reward terms (scales pre-multiplied by dt, zero-scale terms pruned)."""
        cfg = self.cfg.rewards
        sq = torch.square
        cmd = q["commands"]
        jh0 = self.cfg.commands.ranges.jump_height[0]
        terms = {}
        terms["tracking_lin_vel"] = torch.exp(
            -torch.sum(sq(cmd[:, :2] - q["base_lin_vel"][:, :2]), -1) / cfg.tracking_sigma)
        terms["tracking_ang_vel"] = torch.exp(
            -sq(cmd[:, 2] - q["base_ang_vel"][:, 2]) / cfg.tracking_sigma)
        jump_err = torch.abs(cmd[:, 3] - q["root_h"])
        terms["jump_up_height"] = torch.where((jump_err < 0.05) & (cmd[:, 3] >= jh0),
                                              cfg.jump_goal, 0.0)
        loco_rwd = torch.exp(-10.0 * sq(torch.abs(cmd[:, 4] - q["root_h"])) / cfg.tracking_sigma)
        terms["locomotion_height"] = torch.where(~(cmd[:, 3] > jh0), loco_rwd, 0.0)
        terms["torques"] = torch.sum(sq(q["torques_org"]), -1)
        terms["delta_torques"] = torch.sum(sq(q["torques_org"] - q["last_torques_org"]), -1)
        terms["dof_acc"] = torch.sum(sq((q["last_dof_vel"] - q["dof_vel"]) / self.dt), -1)
        pen_force = torch.linalg.vector_norm(q["body_forces"][:, self.penalized_idx], dim=-1)
        terms["collision"] = torch.sum((pen_force > 0.1).to(cmd.dtype), -1)
        terms["action_rate"] = torch.sum(sq(q["last_actions"] - q["actions"]), -1)
        out_low = -torch.clamp(q["dof_pos"] - self.soft_dof_lower, max=0.0)
        out_high = torch.clamp(q["dof_pos"] - self.soft_dof_upper, min=0.0)
        terms["dof_pos_limits"] = torch.sum(out_low + out_high, -1)
        terms["dof_vel_limits"] = torch.sum(torch.clamp(
            torch.abs(q["dof_vel"]) - self.dof_vel_limit * cfg.soft_dof_vel_limit, 0.0, 1.0), -1)
        default = self.mc.default_dof_pos
        terms["hip_pos"] = torch.sum(sq(q["dof_pos"][:, self.hip_dofs] - default[self.hip_dofs]), -1)
        terms["dof_error"] = torch.sum(sq(q["dof_pos"] - default), -1)
        terms["torque_limits"] = torch.sum(torch.clamp(
            torch.abs(q["torques_org"]) - self.dof_effort_limit * cfg.soft_torque_limit,
            min=0.0), -1)
        scaled = torch.stack([terms[n] for n in self.reward_names], dim=-1) * self.reward_scales
        total = torch.sum(scaled, dim=-1)
        if cfg.only_positive_rewards:
            total = torch.clamp(total, min=0.0)
        return total, scaled
