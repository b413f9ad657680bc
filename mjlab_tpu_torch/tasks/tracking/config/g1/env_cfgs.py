"""Unitree G1 motion-tracking configurations (port of
mjlab_tpu/tasks/tracking/config/g1/env_cfgs.py). The tracking scene compiles
to the same model as the velocity-flat one, so both tasks load
assets/g1_velocity_flat.npz (tests/test_torch_tracking_cfg.py keeps the two
compiles equal)."""

from __future__ import annotations

from mjlab_tpu_torch.assets import G1_VELOCITY_FLAT
from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
  G1_ACTION_SCALE,
  get_g1_robot_cfg,
)
from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.tasks.tracking.tracking_env_cfg import create_tracking_env_cfg

BODY_NAMES = (
  "pelvis",
  "left_hip_roll_link",
  "left_knee_link",
  "left_ankle_roll_link",
  "right_hip_roll_link",
  "right_knee_link",
  "right_ankle_roll_link",
  "torso_link",
  "left_shoulder_roll_link",
  "left_elbow_link",
  "left_wrist_yaw_link",
  "right_shoulder_roll_link",
  "right_elbow_link",
  "right_wrist_yaw_link",
)


def g1_flat_tracking_env_cfg() -> ManagerBasedRlEnvCfg:
  """Fresh G1 flat tracking cfg (the JAX package's G1_FLAT_TRACKING_ENV_CFG),
  bound to its compiled scene. The motion file is set by `train <Task>
  --motion-file <path.npz>`; building the env without one raises."""
  self_collision_cfg = ContactSensorCfg(
    name="self_collision",
    primary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
    secondary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
    fields=("found",),
    reduce="none",
  )
  cfg = create_tracking_env_cfg(
    robot_cfg=get_g1_robot_cfg(),
    action_scale=G1_ACTION_SCALE,
    viewer_body_name="torso_link",
    motion_file="",
    anchor_body_name="torso_link",
    body_names=BODY_NAMES,
    foot_friction_geom_names=(r"^(left|right)_foot[1-7]_collision$",),
    ee_body_names=(
      "left_ankle_roll_link",
      "right_ankle_roll_link",
      "left_wrist_yaw_link",
      "right_wrist_yaw_link",
    ),
    base_com_body_name="torso_link",
    sensors=(self_collision_cfg,),
    pose_range={
      "x": (-0.05, 0.05),
      "y": (-0.05, 0.05),
      "z": (-0.01, 0.01),
      "roll": (-0.1, 0.1),
      "pitch": (-0.1, 0.1),
      "yaw": (-0.2, 0.2),
    },
    velocity_range={
      "x": (-0.5, 0.5),
      "y": (-0.5, 0.5),
      "z": (-0.2, 0.2),
      "roll": (-0.52, 0.52),
      "pitch": (-0.52, 0.52),
      "yaw": (-0.78, 0.78),
    },
    joint_position_range=(-0.1, 0.1),
  )
  cfg.scene.model_file = G1_VELOCITY_FLAT
  return cfg


def g1_flat_tracking_no_state_estimation_env_cfg() -> ManagerBasedRlEnvCfg:
  """The variant without state estimation (the JAX package's
  G1_FLAT_TRACKING_NO_STATE_ESTIMATION_ENV_CFG): no motion_anchor_pos_b
  and no base_lin_vel policy observation."""
  cfg = g1_flat_tracking_env_cfg()
  cfg.observations["policy"].terms.pop("motion_anchor_pos_b")
  cfg.observations["policy"].terms.pop("base_lin_vel")
  return cfg
