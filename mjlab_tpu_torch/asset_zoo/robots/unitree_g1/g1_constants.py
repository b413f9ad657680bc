"""Unitree G1 (29-DoF humanoid) constants as data (port of the numbers of
mjlab_tpu/asset_zoo/robots/unitree_g1/g1_constants.py:30-152).

PD gains come from a 10 Hz target natural frequency on each motor's
reflected inertia; the 4-bar-linkage waist and ankle joints are two 5020
motors in parallel. The compiled gains are already in the scene npz; these
groups give the action scales and the articulation's record. The MjSpec,
mesh and collision-preset parts stay in the JAX package.
"""

from __future__ import annotations

import copy

from mjlab_tpu_torch.asset_zoo.robots import action_scale_from_articulation
from mjlab_tpu_torch.asset_zoo.robots.unitree_motors import (
  MOTOR_4010,
  MOTOR_5020,
  MOTOR_7520_14,
  MOTOR_7520_22,
)
from mjlab_tpu_torch.entity import EntityArticulationInfoCfg, EntityCfg
from mjlab_tpu_torch.utils.spec_config import ActuatorCfg

NATURAL_FREQ_HZ = 10.0
DAMPING_RATIO = 2.0

# Parallel-linkage joints: two 5020s act on each waist-pitch/roll and ankle
# joint; with a nominal 1:1 linkage ratio the effective armature, effort
# and gains double.
MOTOR_5020_X2 = MOTOR_5020.scaled(2.0)


def _actuator_cfg(motor, joint_names_expr: tuple[str, ...]) -> ActuatorCfg:
  kp, kd = motor.pd_gains(NATURAL_FREQ_HZ, DAMPING_RATIO)
  return ActuatorCfg(
    joint_names_expr=joint_names_expr,
    effort_limit=motor.effort_limit,
    armature=motor.reflected_inertia,
    stiffness=kp,
    damping=kd,
  )


G1_ACTUATOR_5020 = _actuator_cfg(
  MOTOR_5020,
  (
    ".*_elbow_joint",
    ".*_shoulder_pitch_joint",
    ".*_shoulder_roll_joint",
    ".*_shoulder_yaw_joint",
    ".*_wrist_roll_joint",
  ),
)
G1_ACTUATOR_7520_14 = _actuator_cfg(
  MOTOR_7520_14,
  (".*_hip_pitch_joint", ".*_hip_yaw_joint", "waist_yaw_joint"),
)
G1_ACTUATOR_7520_22 = _actuator_cfg(
  MOTOR_7520_22, (".*_hip_roll_joint", ".*_knee_joint")
)
G1_ACTUATOR_4010 = _actuator_cfg(
  MOTOR_4010, (".*_wrist_pitch_joint", ".*_wrist_yaw_joint")
)
G1_ACTUATOR_WAIST = _actuator_cfg(
  MOTOR_5020_X2, ("waist_pitch_joint", "waist_roll_joint")
)
G1_ACTUATOR_ANKLE = _actuator_cfg(
  MOTOR_5020_X2, (".*_ankle_pitch_joint", ".*_ankle_roll_joint")
)

HOME_KEYFRAME = EntityCfg.InitialStateCfg(
  pos=(0, 0, 0.783675),
  joint_pos={
    ".*_hip_pitch_joint": -0.1,
    ".*_knee_joint": 0.3,
    ".*_ankle_pitch_joint": -0.2,
    ".*_shoulder_pitch_joint": 0.2,
    ".*_elbow_joint": 1.28,
    "left_shoulder_roll_joint": 0.2,
    "right_shoulder_roll_joint": -0.2,
  },
  joint_vel={".*": 0.0},
)

KNEES_BENT_KEYFRAME = EntityCfg.InitialStateCfg(
  pos=(0, 0, 0.76),
  joint_pos={
    ".*_hip_pitch_joint": -0.312,
    ".*_knee_joint": 0.669,
    ".*_ankle_pitch_joint": -0.363,
    ".*_elbow_joint": 0.6,
    "left_shoulder_roll_joint": 0.2,
    "left_shoulder_pitch_joint": 0.2,
    "right_shoulder_roll_joint": -0.2,
    "right_shoulder_pitch_joint": 0.2,
  },
  joint_vel={".*": 0.0},
)

G1_ARTICULATION = EntityArticulationInfoCfg(
  actuators=(
    G1_ACTUATOR_5020,
    G1_ACTUATOR_7520_14,
    G1_ACTUATOR_7520_22,
    G1_ACTUATOR_4010,
    G1_ACTUATOR_WAIST,
    G1_ACTUATOR_ANKLE,
  ),
  soft_joint_pos_limit_factor=0.9,
)

G1_ACTION_SCALE = action_scale_from_articulation(G1_ARTICULATION, factor=0.25)


def get_g1_robot_cfg() -> EntityCfg:
  """Fresh G1 EntityCfg (a new instance per call)."""
  return EntityCfg(
    init_state=copy.deepcopy(KNEES_BENT_KEYFRAME),
    articulation=G1_ARTICULATION,
  )
