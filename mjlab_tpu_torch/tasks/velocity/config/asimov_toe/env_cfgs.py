"""Asimov-Toe velocity-tracking configurations, flat and rough terrain
(port of mjlab_tpu/tasks/velocity/config/asimov_toe/env_cfgs.py): hips and
knees through joint-position actions, the ankles through the pitch/roll →
A/B tendon mapping, the toes passive. The compiled scenes are
assets/asimov_toe_velocity_flat.npz and asimov_toe_velocity_rough.npz
(tests/test_torch_asimov_model.py and tests/test_torch_rough_models.py keep
them fresh); on rough terrain the foot and toe capsules meet the terrain
boxes. As for Asimov, the Newton solver runs
asimov.env_cfgs.NEWTON_ITERATIONS iterations (that module says why)."""

from __future__ import annotations

from mjlab_tpu_torch.assets import ASIMOV_TOE_VELOCITY_FLAT, ASIMOV_TOE_VELOCITY_ROUGH
from mjlab_tpu_torch.asset_zoo.robots.asimov.asimov_toe_constants import (
  ASIMOV_ACTION_SCALE,
  get_asimov_robot_cfg,
)
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.envs.mdp.actions import (
  AnklePrToTendonActionCfg,
  JointPositionActionCfg,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.scene import TerrainImporterCfg
from mjlab_tpu_torch.tasks.velocity.config.asimov.env_cfgs import (
  NEWTON_ITERATIONS,
  asimov_sensor_cfgs,
)
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import create_velocity_env_cfg

_POSTURE_STD_WALKING = {
  r".*hip_pitch.*": 0.5,
  r".*hip_roll.*": 0.12,
  r".*hip_yaw.*": 0.1,
  r".*knee.*": 0.5,
  r".*ankle_pitch.*": 0.2,
  r".*ankle_roll.*": 0.12,
  r".*toe.*": 0.3,
}
_POSTURE_STD_RUNNING = {
  r".*hip_pitch.*": 0.8,
  r".*hip_roll.*": 0.18,
  r".*hip_yaw.*": 0.15,
  r".*knee.*": 0.8,
  r".*ankle_pitch.*": 0.25,
  r".*ankle_roll.*": 0.15,
  r".*toe.*": 0.4,
}

_LEG_JOINTS = tuple(
  f"{side}_{j}_joint"
  for side in ("left", "right")
  for j in ("hip_pitch", "hip_roll", "hip_yaw", "knee", "ankle_pitch",
            "ankle_roll")
)


def _make_cfg(terrain: TerrainImporterCfg | None) -> ManagerBasedRlEnvCfg:
  feet_ground_cfg, self_collision_cfg = asimov_sensor_cfgs()
  scale_non_ankle_toe = {
    k: v for k, v in ASIMOV_ACTION_SCALE.items()
    if "ankle" not in k and "toe" not in k
  }
  scale_ankles = {k: v for k, v in ASIMOV_ACTION_SCALE.items() if "ankle" in k}

  cfg = create_velocity_env_cfg(
    robot_cfg=get_asimov_robot_cfg(),
    action_scale=scale_non_ankle_toe,
    viewer_body_name="pelvis_link",
    site_names=(
      "left_ankle_roll_joint_site",
      "right_ankle_roll_joint_site",
    ),
    feet_sensor_cfg=feet_ground_cfg,
    self_collision_sensor_cfg=self_collision_cfg,
    foot_friction_geom_names=(
      r"left_foot\d+_collision",
      r"left_toe\d+_collision",
      r"right_foot\d+_collision",
      r"right_toe\d+_collision",
    ),
    posture_std_standing={".*": 0.05},
    posture_std_walking=_POSTURE_STD_WALKING,
    posture_std_running=_POSTURE_STD_RUNNING,
    body_ang_vel_weight=-0.08,
    angular_momentum_weight=-0.03,
    self_collision_weight=-1.0,
    air_time_weight=1.0,
    terrain=terrain,
  )
  twist = cfg.commands["twist"]
  # Forward-only starting point of the curriculum.
  twist.ranges.lin_vel_x = (0.0, 0.8)
  twist.ranges.lin_vel_y = (0.0, 0.0)
  twist.ranges.ang_vel_z = (-0.8, 0.8)

  # Actions: joint positions for everything but the ankles and toes, the
  # pitch/roll → A/B tendon mapping for the ankles (the toes stay passive).
  cfg.actions = {
    "joint_pos": JointPositionActionCfg(
      asset_name="robot",
      actuator_names=(r"^(?!.*(ankle|toe)).*$",),
      scale=scale_non_ankle_toe,
      use_default_offset=True,
      preserve_order=True,
    ),
    "ankle_ab": AnklePrToTendonActionCfg(
      asset_name="robot",
      scale=scale_ankles,
      offset=0.0,
      use_default_offset=True,
      L=0.04,
      d=0.02,
    ),
  }

  # The observation layout of deployment: no linear velocity, the 12 leg
  # joints only, the command renamed velocity_commands, a fixed order.
  policy_obs = cfg.observations["policy"]
  critic_obs = cfg.observations["critic"]
  policy_obs.terms.pop("base_lin_vel", None)
  critic_obs.terms.pop("base_lin_vel", None)
  joint_asset_cfg = SceneEntityCfg("robot", joint_names=_LEG_JOINTS)
  for terms in (policy_obs.terms, critic_obs.terms):
    for name in ("joint_pos", "joint_vel"):
      if name in terms:
        terms[name].params["asset_cfg"] = joint_asset_cfg
    if "command" in terms:
      terms["velocity_commands"] = terms.pop("command")

  order = ("base_ang_vel", "projected_gravity", "velocity_commands",
           "joint_pos", "joint_vel", "actions")
  reordered = {n: policy_obs.terms[n] for n in order if n in policy_obs.terms}
  for name, term in policy_obs.terms.items():
    reordered.setdefault(name, term)
  policy_obs.terms = reordered
  cfg.sim.mujoco.iterations = NEWTON_ITERATIONS
  return cfg


def asimov_toe_rough_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Asimov-Toe cfg on the default rough generator terrain, bound to
  its compiled scene. One more setting differs from the JAX package's:
  `capsule_terrain_from_above`. With the JAX package's capsule–box contact
  (the end beside the segment point nearest the box's centre) a toe
  capsule tilted over a large stair slab contacts at its higher end, sinks
  unseen through the 3.5 cm slab past its mid-plane, and the contact then
  flips to the slab's bottom face: from a recorded state one env step
  leaves the joints at 1910.9 rad/s in both packages (MuJoCo: 47.5), and
  training at 4096 envs goes NaN in its first iteration (ROADMAP Queue C)."""
  cfg = _make_cfg(terrain=None)
  cfg.sim.capsule_terrain_from_above = True
  cfg.scene.model_file = ASIMOV_TOE_VELOCITY_ROUGH
  return cfg


def asimov_toe_flat_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Asimov-Toe flat-terrain cfg, bound to its compiled scene."""
  cfg = _make_cfg(terrain=TerrainImporterCfg(terrain_type="plane"))
  cfg.scene.model_file = ASIMOV_TOE_VELOCITY_FLAT
  return cfg
