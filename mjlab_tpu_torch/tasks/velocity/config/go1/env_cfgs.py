"""Unitree Go1 velocity-tracking configurations, flat and rough terrain
(port of mjlab_tpu/tasks/velocity/config/go1/env_cfgs.py). The compiled
scenes are assets/go1_velocity_flat.npz and go1_velocity_rough.npz, which
the JAX package's scene layer compiles from the same configurations
(tests/test_torch_go1_model.py and tests/test_torch_rough_models.py keep
them fresh). On rough terrain the trunk, a box, collides with the terrain
boxes through the hull SAT.

The `illegal_contact` termination reads the `nonfoot_ground_touch` sensor,
whose secondary "terrain" never matches the compiled "/terrain" body, so it
never fires, as in the JAX package (ROADMAP Queue C)."""

from __future__ import annotations

from mjlab_tpu_torch.assets import GO1_VELOCITY_FLAT, GO1_VELOCITY_ROUGH
from mjlab_tpu_torch.asset_zoo.robots.unitree_go1.go1_constants import (
  GO1_ACTION_SCALE,
  get_go1_robot_cfg,
)
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.managers.manager_term_config import TerminationTermCfg
from mjlab_tpu_torch.scene import TerrainImporterCfg
from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.tasks.velocity import mdp
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import create_velocity_env_cfg

_FOOT_NAMES = ("FR", "FL", "RR", "RL")
_GEOM_NAMES = tuple(f"{n}_foot_collision" for n in _FOOT_NAMES)


def _make_cfg(terrain: TerrainImporterCfg | None) -> ManagerBasedRlEnvCfg:
  feet_ground_cfg = ContactSensorCfg(
    name="feet_ground_contact",
    primary=ContactMatch(mode="geom", pattern=_GEOM_NAMES, entity="robot"),
    secondary=ContactMatch(mode="body", pattern="terrain"),
    fields=("found", "force"),
    reduce="netforce",
    track_air_time=True,
  )
  nonfoot_ground_cfg = ContactSensorCfg(
    name="nonfoot_ground_touch",
    primary=ContactMatch(
      mode="geom",
      entity="robot",
      pattern=r".*_collision\d*$",
      exclude=tuple(_GEOM_NAMES),
    ),
    secondary=ContactMatch(mode="body", pattern="terrain"),
    fields=("found",),
    reduce="none",
  )
  cfg = create_velocity_env_cfg(
    robot_cfg=get_go1_robot_cfg(),
    action_scale=GO1_ACTION_SCALE,
    viewer_body_name="trunk",
    site_names=_FOOT_NAMES,
    feet_sensor_cfg=feet_ground_cfg,
    self_collision_sensor_cfg=nonfoot_ground_cfg,
    foot_friction_geom_names=_GEOM_NAMES,
    posture_std_standing={
      r".*(FR|FL|RR|RL)_(hip|thigh)_joint.*": 0.05,
      r".*(FR|FL|RR|RL)_calf_joint.*": 0.1,
    },
    posture_std_walking={
      r".*(FR|FL|RR|RL)_(hip|thigh)_joint.*": 0.3,
      r".*(FR|FL|RR|RL)_calf_joint.*": 0.6,
    },
    posture_std_running={
      r".*(FR|FL|RR|RL)_(hip|thigh)_joint.*": 0.3,
      r".*(FR|FL|RR|RL)_calf_joint.*": 0.6,
    },
    body_ang_vel_weight=0.0,
    angular_momentum_weight=0.0,
    self_collision_weight=0.0,
    air_time_weight=0.0,
    terrain=terrain,
  )
  cfg.terminations["illegal_contact"] = TerminationTermCfg(
    func=mdp.illegal_contact, params={"sensor_name": "nonfoot_ground_touch"}
  )
  return cfg


def unitree_go1_rough_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Go1 cfg on the default rough generator terrain, bound to its
  compiled scene."""
  cfg = _make_cfg(terrain=None)
  cfg.scene.model_file = GO1_VELOCITY_ROUGH
  return cfg


def unitree_go1_flat_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh Go1 flat-terrain cfg, bound to its compiled scene."""
  cfg = _make_cfg(terrain=TerrainImporterCfg(terrain_type="plane"))
  cfg.scene.model_file = GO1_VELOCITY_FLAT
  return cfg
