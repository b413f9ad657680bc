"""Motion-imitation task configuration factory (port of
mjlab_tpu/tasks/tracking/tracking_env_cfg.py, a BeyondMimic
re-implementation): the motion command, 8 policy and 10 critic observation
terms, an interval push and three startup randomizations (base COM, default
joint positions, foot friction), 9 rewards and 4 terminations around a robot
EntityCfg, on the plane terrain."""

from __future__ import annotations

from copy import deepcopy

from mjlab_tpu_torch.entity import EntityCfg
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.envs.mdp.actions import JointPositionActionCfg
from mjlab_tpu_torch.managers.manager_term_config import (
  ActionTermCfg,
  CommandTermCfg,
  EventTermCfg,
  ObservationGroupCfg,
  ObservationTermCfg,
  RewardTermCfg,
  TerminationTermCfg,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.scene import SceneCfg, TerrainImporterCfg
from mjlab_tpu_torch.sensors import ContactSensorCfg
from mjlab_tpu_torch.tasks.tracking import mdp
from mjlab_tpu_torch.tasks.tracking.mdp import MotionCommandCfg
# The JAX package's tracking SIM_CFG differs from the velocity one only in
# contact capacities, which the port does not have.
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import sim_cfg
from mjlab_tpu_torch.utils.noise import UniformNoiseCfg as Unoise


def create_tracking_env_cfg(
  robot_cfg: EntityCfg,
  action_scale: float | dict[str, float],
  viewer_body_name: str,
  motion_file: str,
  anchor_body_name: str,
  body_names: tuple[str, ...],
  foot_friction_geom_names: tuple[str, ...],
  ee_body_names: tuple[str, ...],
  base_com_body_name: str,
  sensors: tuple[ContactSensorCfg, ...],
  pose_range: dict[str, tuple[float, float]],
  velocity_range: dict[str, tuple[float, float]],
  joint_position_range: tuple[float, float],
) -> ManagerBasedRlEnvCfg:
  """Assemble the motion-imitation MDP for a robot. `viewer_body_name` is
  kept for the JAX package's signature; the port has no viewer."""
  del viewer_body_name
  scene = SceneCfg(
    terrain=TerrainImporterCfg(terrain_type="plane"),
    num_envs=1,
    entities={"robot": robot_cfg},
    sensors=deepcopy(sensors),
  )

  actions: dict[str, ActionTermCfg] = {
    "joint_pos": JointPositionActionCfg(
      asset_name="robot",
      actuator_names=(".*",),
      scale=action_scale,
      use_default_offset=True,
    )
  }

  commands: dict[str, CommandTermCfg] = {
    "motion": MotionCommandCfg(
      asset_name="robot",
      resampling_time_range=(1.0e9, 1.0e9),  # the clock never fires; RSI on reset
      pose_range=pose_range,
      velocity_range=velocity_range,
      joint_position_range=joint_position_range,
      motion_file=motion_file,
      anchor_body_name=anchor_body_name,
      body_names=body_names,
    )
  }

  motion = {"command_name": "motion"}
  policy_terms = {
    "command": ObservationTermCfg(func=mdp.generated_commands, params=dict(motion)),
    "motion_anchor_pos_b": ObservationTermCfg(
      func=mdp.motion_anchor_pos_b, params=dict(motion), noise=Unoise(n_min=-0.25, n_max=0.25),
    ),
    "motion_anchor_ori_b": ObservationTermCfg(
      func=mdp.motion_anchor_ori_b, params=dict(motion), noise=Unoise(n_min=-0.05, n_max=0.05),
    ),
    "base_lin_vel": ObservationTermCfg(
      func=mdp.builtin_sensor, params={"sensor_name": "robot/imu_lin_vel"},
      noise=Unoise(n_min=-0.5, n_max=0.5),
    ),
    "base_ang_vel": ObservationTermCfg(
      func=mdp.builtin_sensor, params={"sensor_name": "robot/imu_ang_vel"},
      noise=Unoise(n_min=-0.2, n_max=0.2),
    ),
    "joint_pos": ObservationTermCfg(func=mdp.joint_pos_rel,
                                    noise=Unoise(n_min=-0.01, n_max=0.01)),
    "joint_vel": ObservationTermCfg(func=mdp.joint_vel_rel,
                                    noise=Unoise(n_min=-0.5, n_max=0.5)),
    "actions": ObservationTermCfg(func=mdp.last_action),
  }

  critic_terms = {
    "command": ObservationTermCfg(func=mdp.generated_commands, params=dict(motion)),
    "motion_anchor_pos_b": ObservationTermCfg(func=mdp.motion_anchor_pos_b,
                                              params=dict(motion)),
    "motion_anchor_ori_b": ObservationTermCfg(func=mdp.motion_anchor_ori_b,
                                              params=dict(motion)),
    "body_pos": ObservationTermCfg(func=mdp.robot_body_pos_b, params=dict(motion)),
    "body_ori": ObservationTermCfg(func=mdp.robot_body_ori_b, params=dict(motion)),
    "base_lin_vel": ObservationTermCfg(func=mdp.builtin_sensor,
                                       params={"sensor_name": "robot/imu_lin_vel"}),
    "base_ang_vel": ObservationTermCfg(func=mdp.builtin_sensor,
                                       params={"sensor_name": "robot/imu_ang_vel"}),
    "joint_pos": ObservationTermCfg(func=mdp.joint_pos_rel),
    "joint_vel": ObservationTermCfg(func=mdp.joint_vel_rel),
    "actions": ObservationTermCfg(func=mdp.last_action),
  }

  observations = {
    "policy": ObservationGroupCfg(terms=policy_terms, concatenate_terms=True,
                                  enable_corruption=True),
    "critic": ObservationGroupCfg(terms=critic_terms, concatenate_terms=True,
                                  enable_corruption=False),
  }

  events: dict[str, EventTermCfg] = {
    "push_robot": EventTermCfg(
      func=mdp.push_by_setting_velocity,
      mode="interval",
      interval_range_s=(1.0, 3.0),
      params={"velocity_range": velocity_range},
    ),
    "base_com": EventTermCfg(
      mode="startup",
      func=mdp.randomize_field,
      domain_randomization=True,
      params={
        "asset_cfg": SceneEntityCfg("robot", body_names=(base_com_body_name,)),
        "operation": "add",
        "field": "body_ipos",
        "ranges": {0: (-0.025, 0.025), 1: (-0.05, 0.05), 2: (-0.05, 0.05)},
      },
    ),
    "add_joint_default_pos": EventTermCfg(
      mode="startup",
      func=mdp.randomize_field,
      domain_randomization=True,
      params={
        "asset_cfg": SceneEntityCfg("robot"),
        "operation": "add",
        "field": "qpos0",
        "ranges": (-0.01, 0.01),
      },
    ),
    "foot_friction": EventTermCfg(
      mode="startup",
      func=mdp.randomize_field,
      domain_randomization=True,
      params={
        "asset_cfg": SceneEntityCfg("robot", geom_names=foot_friction_geom_names),
        "operation": "abs",
        "field": "geom_friction",
        "ranges": (0.3, 1.2),
      },
    ),
  }

  rewards: dict[str, RewardTermCfg] = {
    "motion_global_root_pos": RewardTermCfg(
      func=mdp.motion_global_anchor_position_error_exp, weight=0.5,
      params={**motion, "std": 0.3},
    ),
    "motion_global_root_ori": RewardTermCfg(
      func=mdp.motion_global_anchor_orientation_error_exp, weight=0.5,
      params={**motion, "std": 0.4},
    ),
    "motion_body_pos": RewardTermCfg(
      func=mdp.motion_relative_body_position_error_exp, weight=1.0,
      params={**motion, "std": 0.3},
    ),
    "motion_body_ori": RewardTermCfg(
      func=mdp.motion_relative_body_orientation_error_exp, weight=1.0,
      params={**motion, "std": 0.4},
    ),
    "motion_body_lin_vel": RewardTermCfg(
      func=mdp.motion_global_body_linear_velocity_error_exp, weight=1.0,
      params={**motion, "std": 1.0},
    ),
    "motion_body_ang_vel": RewardTermCfg(
      func=mdp.motion_global_body_angular_velocity_error_exp, weight=1.0,
      params={**motion, "std": 3.14},
    ),
    "action_rate_l2": RewardTermCfg(func=mdp.action_rate_l2, weight=-1e-1),
    "joint_limit": RewardTermCfg(
      func=mdp.joint_pos_limits, weight=-10.0,
      params={"asset_cfg": SceneEntityCfg("robot", joint_names=(".*",))},
    ),
    "self_collisions": RewardTermCfg(
      func=mdp.self_collision_cost, weight=-10.0,
      params={"sensor_name": "self_collision"},
    ),
  }

  terminations: dict[str, TerminationTermCfg] = {
    "time_out": TerminationTermCfg(func=mdp.time_out, time_out=True),
    "anchor_pos": TerminationTermCfg(
      func=mdp.bad_anchor_pos_z_only, params={**motion, "threshold": 0.25},
    ),
    "anchor_ori": TerminationTermCfg(
      func=mdp.bad_anchor_ori,
      params={"asset_cfg": SceneEntityCfg("robot"), **motion, "threshold": 0.8},
    ),
    "ee_body_pos": TerminationTermCfg(
      func=mdp.bad_motion_body_pos_z_only,
      params={**motion, "threshold": 0.25, "body_names": ee_body_names},
    ),
  }

  return ManagerBasedRlEnvCfg(
    scene=scene,
    observations=observations,
    actions=actions,
    commands=commands,
    rewards=rewards,
    terminations=terminations,
    events=events,
    sim=sim_cfg(),
    decimation=4,
    episode_length_s=10.0,
  )
