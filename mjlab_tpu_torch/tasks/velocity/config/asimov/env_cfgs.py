"""Asimov biped velocity-tracking configurations, flat and rough terrain
(port of mjlab_tpu/tasks/velocity/config/asimov/env_cfgs.py). The compiled
scenes are assets/asimov_velocity_flat.npz and asimov_velocity_rough.npz,
which the JAX package's scene layer compiles from the same configurations
(tests/test_torch_asimov_model.py and tests/test_torch_rough_models.py
keep them fresh). On rough terrain the feet's hulls collide with the
terrain boxes through the hull SAT.

One setting differs from the JAX package's, for both Asimov variants: the
Newton solver runs NEWTON_ITERATIONS (30) iterations, not the velocity
tasks' 10. At 10 the JAX package's solver (an unbracketed linesearch whose
non-improving steps are rejected) leaves foot strikes of these light feet
unconverged, and the implicit integrator turns the spurious contact force
into ankle velocities of hundreds of rad/s, from which training at 4096
envs runs into NaN within its first iteration.
`mujoco.mj_step` converges there at 10 (tests/test_torch_asimov_physics.py
`test_newton_at_ten_iterations_leaves_a_foot_strike_unconverged`)."""

from __future__ import annotations

from mjlab_tpu_torch.assets import ASIMOV_VELOCITY_FLAT, ASIMOV_VELOCITY_ROUGH
from mjlab_tpu_torch.asset_zoo.robots.asimov.asimov_constants import (
  ASIMOV_ACTION_SCALE,
  get_asimov_robot_cfg,
)
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.scene import TerrainImporterCfg
from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import create_velocity_env_cfg

NEWTON_ITERATIONS = 30

# Walking/running posture stds: wide canted hip pitch, constrained ankles
# (limited range of motion).
_POSTURE_STD_WALKING = {
  r".*hip_pitch.*": 0.5,
  r".*hip_roll.*": 0.25,
  r".*hip_yaw.*": 0.2,
  r".*knee.*": 0.5,
  r".*ankle_pitch.*": 0.2,
  r".*ankle_roll.*": 0.12,
}
_POSTURE_STD_RUNNING = {
  r".*hip_pitch.*": 0.8,
  r".*hip_roll.*": 0.35,
  r".*hip_yaw.*": 0.3,
  r".*knee.*": 0.8,
  r".*ankle_pitch.*": 0.25,
  r".*ankle_roll.*": 0.15,
}


def asimov_sensor_cfgs() -> tuple[ContactSensorCfg, ContactSensorCfg]:
  """The feet-ground and self-collision contact sensors both Asimov variants
  use (their secondary "terrain" never matches the compiled "/terrain", as
  in the JAX package)."""
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
    primary=ContactMatch(mode="subtree", pattern="pelvis_link", entity="robot"),
    secondary=ContactMatch(mode="subtree", pattern="pelvis_link", entity="robot"),
    fields=("found",),
    reduce="none",
  )
  return feet_ground_cfg, self_collision_cfg


def _make_cfg(terrain: TerrainImporterCfg | None) -> ManagerBasedRlEnvCfg:
  feet_ground_cfg, self_collision_cfg = asimov_sensor_cfgs()
  cfg = create_velocity_env_cfg(
    robot_cfg=get_asimov_robot_cfg(),
    action_scale=ASIMOV_ACTION_SCALE,
    viewer_body_name="pelvis_link",
    site_names=(
      "left_ankle_roll_joint_site",
      "right_ankle_roll_joint_site",
    ),
    feet_sensor_cfg=feet_ground_cfg,
    self_collision_sensor_cfg=self_collision_cfg,
    foot_friction_geom_names=(
      "left_ankle_roll_link_collision",
      "right_ankle_roll_link_collision",
    ),
    posture_std_standing={".*": 0.05},
    posture_std_walking=_POSTURE_STD_WALKING,
    posture_std_running=_POSTURE_STD_RUNNING,
    body_ang_vel_weight=-0.08,  # narrow stance → less stable
    angular_momentum_weight=-0.03,
    self_collision_weight=-1.0,
    air_time_weight=0.5,  # lighter robot: encourage flight phases
    terrain=terrain,
  )
  twist = cfg.commands["twist"]
  # Conservative ranges: narrow stance, canted hips, limited ankle range.
  twist.ranges.lin_vel_x = (-0.8, 0.8)
  twist.ranges.lin_vel_y = (-0.6, 0.6)
  twist.ranges.ang_vel_z = (-0.6, 0.6)
  cfg.sim.mujoco.iterations = NEWTON_ITERATIONS
  return cfg


def asimov_rough_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Asimov cfg on the default rough generator terrain, bound to its
  compiled scene."""
  cfg = _make_cfg(terrain=None)
  cfg.scene.model_file = ASIMOV_VELOCITY_ROUGH
  return cfg


def asimov_flat_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Asimov flat-terrain cfg, bound to its compiled scene."""
  cfg = _make_cfg(terrain=TerrainImporterCfg(terrain_type="plane"))
  cfg.scene.model_file = ASIMOV_VELOCITY_FLAT
  return cfg
