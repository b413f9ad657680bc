"""Unitree G1 velocity-tracking configurations, flat and rough terrain (port
of mjlab_tpu/tasks/velocity/config/g1/env_cfgs.py). Both bind the compiled
scene assets/g1_velocity_flat.npz, which the JAX package's scene layer
compiles from the flat configuration (tests/test_torch_model_io.py keeps it
fresh); on rough terrain the port generates the terrain and composes it
into that scene (scene/compose.py)."""

from __future__ import annotations

from mjlab_tpu_torch.assets import G1_VELOCITY_FLAT
from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
  G1_ACTION_SCALE,
  get_g1_robot_cfg,
)
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.scene import TerrainImporterCfg
from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import create_velocity_env_cfg

_POSTURE_STD_WALKING = {
  r".*hip_pitch.*": 0.3,
  r".*hip_roll.*": 0.15,
  r".*hip_yaw.*": 0.15,
  r".*knee.*": 0.35,
  r".*ankle_pitch.*": 0.25,
  r".*ankle_roll.*": 0.1,
  r".*waist_yaw.*": 0.2,
  r".*waist_roll.*": 0.08,
  r".*waist_pitch.*": 0.1,
  r".*shoulder_pitch.*": 0.15,
  r".*shoulder_roll.*": 0.15,
  r".*shoulder_yaw.*": 0.1,
  r".*elbow.*": 0.15,
  r".*wrist.*": 0.3,
}

_POSTURE_STD_RUNNING = {
  r".*hip_pitch.*": 0.5,
  r".*hip_roll.*": 0.2,
  r".*hip_yaw.*": 0.2,
  r".*knee.*": 0.6,
  r".*ankle_pitch.*": 0.35,
  r".*ankle_roll.*": 0.15,
  r".*waist_yaw.*": 0.3,
  r".*waist_roll.*": 0.08,
  r".*waist_pitch.*": 0.2,
  r".*shoulder_pitch.*": 0.5,
  r".*shoulder_roll.*": 0.2,
  r".*shoulder_yaw.*": 0.15,
  r".*elbow.*": 0.35,
  r".*wrist.*": 0.3,
}


def _make_cfg(terrain: TerrainImporterCfg | None) -> ManagerBasedRlEnvCfg:
  feet_ground_cfg = ContactSensorCfg(
    name="feet_ground_contact",
    primary=ContactMatch(
      mode="subtree",
      pattern=r"^(left_ankle_roll_link|right_ankle_roll_link)$",
      entity="robot",
    ),
    secondary=ContactMatch(mode="body", pattern="terrain"),
    fields=("found", "force"),
    reduce="netforce",
    track_air_time=True,
  )
  self_collision_cfg = ContactSensorCfg(
    name="self_collision",
    primary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
    secondary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
    fields=("found",),
    reduce="none",
  )
  geom_names = tuple(
    f"{side}_foot{i}_collision" for side in ("left", "right") for i in range(1, 8)
  )
  cfg = create_velocity_env_cfg(
    robot_cfg=get_g1_robot_cfg(),
    action_scale=G1_ACTION_SCALE,
    viewer_body_name="torso_link",
    site_names=("left_foot", "right_foot"),
    feet_sensor_cfg=feet_ground_cfg,
    self_collision_sensor_cfg=self_collision_cfg,
    foot_friction_geom_names=geom_names,
    posture_std_standing={".*": 0.05},
    posture_std_walking=_POSTURE_STD_WALKING,
    posture_std_running=_POSTURE_STD_RUNNING,
    body_ang_vel_weight=-0.05,
    angular_momentum_weight=-0.02,
    self_collision_weight=-1.0,
    air_time_weight=0.0,
    terrain=terrain,
  )
  return cfg


def unitree_g1_rough_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh G1 cfg on the default rough generator terrain, bound to its
  flat scene, into which the port composes the generated terrain."""
  cfg = _make_cfg(terrain=None)
  cfg.scene.model_file = G1_VELOCITY_FLAT
  return cfg


def unitree_g1_flat_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh G1 flat-terrain cfg, bound to its compiled scene."""
  cfg = _make_cfg(terrain=TerrainImporterCfg(terrain_type="plane"))
  cfg.scene.model_file = G1_VELOCITY_FLAT
  return cfg
