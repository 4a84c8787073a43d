"""Config tree for the BBC (go2_locomotion) stack.

The port's own copy of agility_tpu/envs/config.py.

Frozen dataclasses whose leaves mirror the reference's nested-class configs
(bbc/legged_gym/envs/base/legged_robot_config.py + go2/go2_locomotion_config
.py) so hyperparameters carry over one-to-one.  Defaults are the Go2 values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

MOCAP_CATEGORIES = ("walk", "pace", "trot", "canter", "jump")


@dataclasses.dataclass(frozen=True)
class EnvCfg:
    num_envs: int = 4096
    num_actions: int = 12
    num_prop: int = 57
    num_explicit: int = 4
    num_latent: int = 29
    num_command: int = 11            # 5 commands + 1 eps + 5 modes
    num_obs_disc: int = 49
    history_len: int = 10
    disc_obs_len: int = 2
    episode_length_s: float = 20.0
    mocap_state_init: bool = True
    recovery_init_prob: float = 0.0
    mocap_category: Sequence[str] = MOCAP_CATEGORIES        # active subset
    mocap_category_all: Sequence[str] = MOCAP_CATEGORIES    # fixes dim_c = 5
    root_height_obs: bool = True
    send_timeouts: bool = True

    @property
    def num_obs(self) -> int:
        return self.num_prop + self.num_explicit + self.num_latent + self.num_command

    @property
    def num_actor_obs(self) -> int:
        return self.num_obs + self.history_len * self.num_prop


@dataclasses.dataclass(frozen=True)
class TerrainCfg:
    mesh_type: str = "trimesh"       # "plane" | "trimesh"
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 30.0
    curriculum: bool = False
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: Sequence[float] = tuple(
        [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]
    )
    measured_points_y: Sequence[float] = tuple(
        [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
    )
    max_init_terrain_level: int = 5
    terrain_length: float = 10.0
    terrain_width: float = 10.0
    num_rows: int = 10
    num_cols: int = 10
    # [smooth slope, rough slope, stairs up, stairs down, discrete]
    terrain_proportions: Sequence[float] = (0.2, 0.8, 0.0, 0.0, 0.0)
    difficulties: Sequence[float] = (0.0, 0.2, 0.4)
    slope_treshold: float = 0.75


@dataclasses.dataclass(frozen=True)
class CommandRanges:
    # per-mode [walk, pace, trot, canter, jump] (go2_locomotion_config.py:172-177)
    lin_vel_x: Sequence[Tuple[float, float]] = (
        (0.0, 0.6), (0.5, 1.5), (0.5, 1.5), (0.8, 2.5), (0.8, 2.0))
    lin_vel_y: Sequence[Tuple[float, float]] = (
        (-0.15, 0.15), (-0.3, 0.3), (-0.3, 0.3), (-0.5, 0.5), (-0.3, 0.3))
    ang_vel_yaw: Sequence[Tuple[float, float]] = (
        (-1.0, 1.0), (-1.57, 1.57), (-1.57, 1.57), (-0.5, 0.5), (-0.5, 0.5))
    jump_height: Tuple[float, float] = (0.45, 0.58)
    locomotion_height: Tuple[float, float] = (0.25, 0.34)


@dataclasses.dataclass(frozen=True)
class CommandsCfg:
    num_commands: int = 5
    resampling_time: float = 6.0
    heading_command: bool = False
    ranges: CommandRanges = CommandRanges()
    lin_vel_x_clip: float = 0.1
    lin_vel_y_clip: float = 0.05
    ang_vel_yaw_clip: float = 0.05


@dataclasses.dataclass(frozen=True)
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.42)
    rot: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class ControlCfg:
    control_type: str = "P"
    stiffness: float = 40.0
    damping: float = 1.0
    action_scale: float = 0.25
    hip_scale_reduction: float = 0.5
    decimation: int = 4


@dataclasses.dataclass(frozen=True)
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.6, 2.0)
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (0.0, 1.5)
    randomize_base_com: bool = True
    added_com_range: Tuple[float, float] = (-0.1, 0.1)
    push_robots: bool = True
    push_interval_s: float = 8.0
    max_push_vel_xy: float = 0.5
    randomize_motor: bool = True
    motor_strength_range: Tuple[float, float] = (0.8, 1.2)
    use_easi: bool = True
    # EASI-calibrated per-joint-type PD gain distributions
    # (go2_locomotion_config.py:90-95): [kp_hip, kd_hip, kp_thigh, kd_thigh,
    # kp_calf, kd_calf, body_mass]
    easi_mean: Sequence[float] = (
        1.270984856442925803, 1.269402596100474012, 0.8637638584658215990,
        0.8973783516018792872, 0.7804512147922660903, 1.069519100829913416,
        1.0)
    easi_var: Sequence[float] = (
        9.087216265313172864e-03, 6.342416661098186637e-03,
        1.376369951477590226e-05, 4.598280851616735464e-05,
        5.266858327126125377e-06, 8.413655048485571975e-05, 0.0)
    action_delay: bool = True
    action_buf_len: int = 8
    delay_update_global_steps: int = 24 * 20000
    action_curr_step: Sequence[int] = (0, 1)


@dataclasses.dataclass(frozen=True)
class RewardScales:
    # go2_locomotion_config.py:137-163 (zero-scale terms are pruned at build)
    termination: float = 0.0
    tracking_lin_vel: float = 2.0
    tracking_ang_vel: float = 1.5
    jump_up_height: float = 0.2
    locomotion_height: float = 0.1
    lin_vel_z: float = 0.0
    ang_vel_xy: float = 0.0
    orientation: float = 0.0
    torques: float = -0.00001
    delta_torques: float = -1.0e-7
    dof_vel: float = 0.0
    dof_acc: float = -2.5e-7
    base_height: float = 0.0
    feet_air_time: float = 0.0
    collision: float = -10.0
    feet_stumble: float = 0.0
    action_rate: float = -0.1
    stand_still: float = 0.0
    dof_pos_limits: float = -0.1
    dof_vel_limits: float = -0.1
    hip_pos: float = -0.5
    dof_error: float = -0.1
    torque_limits: float = -0.03


@dataclasses.dataclass(frozen=True)
class RewardsCfg:
    scales: RewardScales = RewardScales()
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 0.9
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.25
    max_contact_force: float = 100.0
    jump_goal: float = 10.0


@dataclasses.dataclass(frozen=True)
class ObsScales:
    lin_vel: float = 0.5
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    key_pos: float = 1.0
    foot_contact: float = 1.0
    lin_vel_dist: float = 0.5
    ang_vel_dist: float = 0.25
    height_measurements: float = 5.0


@dataclasses.dataclass(frozen=True)
class NormalizationCfg:
    obs_scales: ObsScales = ObsScales()
    clip_observations: float = 100.0
    clip_actions: float = 100.0
    task_obs_weight_decay: bool = True
    task_obs_weight_decay_steps: int = 50000


@dataclasses.dataclass(frozen=True)
class NoiseScales:
    roll_pitch: float = 0.01
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclasses.dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    scales: NoiseScales = NoiseScales()


@dataclasses.dataclass(frozen=True)
class SimCfg:
    dt: float = 1.0 / 200.0
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    solver: str = "jacobi"
    # warm-start carries contact impulses across substeps, reaching the
    # cold 10-sweep fixed point at 5 sweeps (tests/test_soa.py:209);
    # measured 651.7k -> 684.0k env-steps/s on the BBC full iteration.
    jacobi_iters: int = 5
    jacobi_relax: float = 0.6
    warm_start: bool = True    # (engine.EngineConfig.warm_start)
    # contact band-stack dtype (physics/windows.py, multi-surface worlds
    # only — the BBC terrain never attaches bands): bf16 halves the
    # dominant window-DMA bytes of the TSC control step.  Height rounding
    # is <= 0.4% relative (~2 mm on course obstacle scales, below the 5 mm
    # heightfield quantization the reference trains on, tsc config
    # vertical_scale 0.005); solver equivalence gated by
    # tests/test_windows.py::test_contact_band_bf16_solver_precision.
    contact_band_bf16: bool = True


@dataclasses.dataclass(frozen=True)
class Go2LocomotionCfg:
    env: EnvCfg = EnvCfg()
    terrain: TerrainCfg = TerrainCfg()
    commands: CommandsCfg = CommandsCfg()
    init_state: InitStateCfg = InitStateCfg()
    control: ControlCfg = ControlCfg()
    domain_rand: DomainRandCfg = DomainRandCfg()
    rewards: RewardsCfg = RewardsCfg()
    normalization: NormalizationCfg = NormalizationCfg()
    noise: NoiseCfg = NoiseCfg()
    sim: SimCfg = SimCfg()
    seed: int = 1
    # data
    mocap_dir: Optional[str] = None   # None -> synthetic gait data

    @property
    def dt(self) -> float:
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        import math

        return math.ceil(self.env.episode_length_s / self.dt)


def smoke_cfg(num_envs: int = 64) -> Go2LocomotionCfg:
    """BASELINE.json configs[0]: flat ground, single walk mode, small batch,
    CPU-runnable smoke configuration."""
    return Go2LocomotionCfg(
        env=EnvCfg(num_envs=num_envs, episode_length_s=5.0, mocap_category=("walk",),
                   mocap_state_init=False),
        terrain=TerrainCfg(mesh_type="plane", measure_heights=False),
        domain_rand=DomainRandCfg(push_robots=False, action_delay=False,
                                  randomize_friction=False, randomize_base_mass=False,
                                  randomize_base_com=False, randomize_motor=False,
                                  use_easi=False),
        noise=NoiseCfg(add_noise=False),
    )
