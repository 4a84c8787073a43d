"""Config tree for the TSC (go2 agility) stack, mirroring
tsc/legged_gym/envs/base/legged_robot_config.py + go2/go2_agility_config.py.

The port's own copy of agility_tpu/envs/tsc_config.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from benchmark.reference.plain.envs.config import (
    CommandRanges, ControlCfg, InitStateCfg, NoiseCfg, NoiseScales,
    ObsScales, SimCfg, MOCAP_CATEGORIES,
)
from benchmark.reference.plain.terrain.obstacle import ObstacleCfg


@dataclasses.dataclass(frozen=True)
class TscEnvCfg:
    num_envs: int = 6144
    n_scan: int = 132
    n_priv: int = 4
    n_delta_yaw: int = 2
    n_obst_type: int = 6
    n_priv_latent: int = 29
    history_len: int = 10
    mocap_category: Sequence[str] = ("trot", "canter", "jump")
    mocap_category_all: Sequence[str] = MOCAP_CATEGORIES
    num_actions_c: int = 6            # 5 commands + 1 epsilon
    num_actions_bbc: int = 12
    num_obs_disc: int = 49
    disc_obs_len: int = 2
    episode_length_s: float = 40.0
    next_goal_threshold: float = 0.4
    reach_goal_delay: float = 0.02
    leave_goal_threshold: float = 4.0
    root_height_obs: bool = True
    # spawn reset envs at a RANDOM station's approach goal with the
    # station's heading (reference obstacle.randomize_start,
    # tsc legged_robot.py:367-375 — on via the --randomize_start training
    # flag): uniform obstacle coverage instead of always starting the
    # course from station 0
    randomize_start: bool = False
    randomize_start_yaw: bool = True
    rand_yaw_range: float = 0.2
    randomize_start_x: bool = True
    rand_x_range: float = 0.2
    randomize_start_y: bool = True
    rand_y_range: float = 0.1
    randomize_start_vel: bool = True

    @property
    def n_auxiliary(self) -> int:
        return self.n_delta_yaw + self.n_obst_type

    @property
    def n_proprio(self) -> int:
        return 57 + self.n_auxiliary

    @property
    def num_actions_d(self) -> int:
        return len(self.mocap_category)

    @property
    def num_actions_hl(self) -> int:
        # 1 discrete index + per-mode continuous blocks
        return 1 + self.num_actions_d * self.num_actions_c

    @property
    def num_obs(self) -> int:
        # [prop 65 | scan 132 | priv 4 | priv latent 29 | hist 10*57] = 800
        return (self.n_proprio + self.n_scan + self.n_priv + self.n_priv_latent
                + self.history_len * (self.n_proprio - self.n_auxiliary))

    @property
    def num_obs_bbc(self) -> int:
        # [prop 57 | priv 4 | latent 29 | hist 570 | cmd 5+1+5] = 671
        return (self.n_proprio - self.n_auxiliary + self.n_priv
                + self.n_priv_latent
                + self.history_len * (self.n_proprio - self.n_auxiliary)
                + 5 + 1 + len(self.mocap_category_all))


@dataclasses.dataclass(frozen=True)
class TscDomainRandCfg:
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.6, 2.0)
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (0.0, 1.5)
    randomize_base_com: bool = False
    added_com_range: Tuple[float, float] = (-0.1, 0.1)
    push_robots: bool = False
    push_interval_s: float = 8.0
    max_push_vel_xy: float = 0.5
    randomize_action: bool = True
    action_noise: Tuple[float, float] = (0.8, 1.2)
    randomize_motor: bool = False
    motor_strength_range: Tuple[float, float] = (0.8, 1.2)
    action_delay: bool = True
    action_delay_step: int = 1
    action_buf_len: int = 8


@dataclasses.dataclass(frozen=True)
class TscRewardScales:
    # tsc config :307-341
    termination: float = -50.0
    reach_goal: float = 5.0
    tracking_goal_vel: float = 0.4
    tracking_yaw: float = 2.0
    collision: float = -20.0
    action_hl_rate: float = -0.2
    latent_c_rate: float = -1.0
    feet_edge: float = -1.0


@dataclasses.dataclass(frozen=True)
class TscRewardsCfg:
    scales: TscRewardScales = TscRewardScales()
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    soft_torque_limit: float = 0.4
    max_contact_force: float = 40.0
    target_lin_vel: float = 0.4


@dataclasses.dataclass(frozen=True)
class TscCommandsCfg:
    num_commands: int = 5
    resampling_time: float = 0.02     # == dt: the HL policy re-commands every step
    ranges: CommandRanges = CommandRanges()


@dataclasses.dataclass(frozen=True)
class DepthCfg:
    use_camera: bool = False
    camera_num_envs: int = 256  # depth-student env count (reference
    #                             legged_robot_config.py:65 caps camera
    #                             training at 256; the raycast + CNN/GRU
    #                             activations OOM a v5e chip at >1k envs)
    position: Tuple[float, float, float] = (0.305, 0.0175, 0.098)
    angle_range: Tuple[float, float] = (-5.0, 5.0)    # pitch randomization [deg]
    update_interval: int = 5    # camera refresh period in control steps
    #                             (reference legged_robot_config.py:63-84)
    resized: Tuple[int, int] = (87, 58)               # (W, H)
    horizontal_fov: float = 87.0
    buffer_len: int = 2
    near_clip: float = 0.3
    far_clip: float = 4.0
    depth_noise: float = 0.05


@dataclasses.dataclass(frozen=True)
class Go2AgilityCfg:
    env: TscEnvCfg = TscEnvCfg()
    obstacle: ObstacleCfg = ObstacleCfg()
    commands: TscCommandsCfg = TscCommandsCfg()
    control: ControlCfg = ControlCfg()
    domain_rand: TscDomainRandCfg = TscDomainRandCfg()
    rewards: TscRewardsCfg = TscRewardsCfg()
    noise: NoiseCfg = NoiseCfg(add_noise=False)
    depth: DepthCfg = DepthCfg()
    sim: SimCfg = SimCfg()
    init_state: InitStateCfg = InitStateCfg(pos=(0.0, 0.0, 0.42))
    obs_scales: ObsScales = ObsScales(
        key_pos=0.0, foot_contact=0.0, lin_vel_dist=0.0, ang_vel_dist=0.0)
    clip_observations: float = 100.0
    clip_actions: float = 100.0
    seed: int = 1
    mocap_dir: Optional[str] = None

    @property
    def dt(self) -> float:
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        return math.ceil(self.env.episode_length_s / self.dt)


def tsc_smoke_cfg(num_envs: int = 8, courses: int = 2) -> Go2AgilityCfg:
    return Go2AgilityCfg(
        env=TscEnvCfg(num_envs=num_envs, episode_length_s=10.0),
        obstacle=ObstacleCfg(courses=courses),
        domain_rand=TscDomainRandCfg(
            randomize_friction=False, randomize_action=False, action_delay=False),
    )
