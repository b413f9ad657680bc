"""Asimov biped constants as data (port of the numbers of
mjlab_tpu/asset_zoo/robots/asimov/asimov_constants.py).

G1-series motors with softer PD tuning (8 Hz, ζ=1.8) for the lighter frame;
the parallel-linkage ankles are two 5020s per joint. The compiled gains,
the foot meshes and the feet-only collision preset are already in the scene
npz; these groups give the action scales and the articulation's record.
The left and right legs have mirrored joint axes, so the knees-bent
keyframe uses opposite signs per side.
"""

from __future__ import annotations

import copy

from mjlab_tpu_torch.asset_zoo.robots import action_scale_from_articulation
from mjlab_tpu_torch.asset_zoo.robots.unitree_motors import (
  MOTOR_5020,
  MOTOR_7520_14,
  MOTOR_7520_22,
)
from mjlab_tpu_torch.entity import EntityArticulationInfoCfg, EntityCfg
from mjlab_tpu_torch.utils.spec_config import ActuatorCfg

NATURAL_FREQ_HZ = 8.0  # softer than G1's 10 Hz: ~50% of the mass
DAMPING_RATIO = 1.8

# Parallel-linkage ankles: two 5020s per joint.
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


ASIMOV_ACTUATOR_HIP_PITCH_YAW = _actuator_cfg(
  MOTOR_7520_14, (".*_hip_pitch_joint", ".*_hip_yaw_joint")
)
ASIMOV_ACTUATOR_HIP_ROLL_KNEE = _actuator_cfg(
  MOTOR_7520_22, (".*_hip_roll_joint", ".*_knee_joint")
)
ASIMOV_ACTUATOR_ANKLE = _actuator_cfg(
  MOTOR_5020_X2, (".*_ankle_pitch_joint", ".*_ankle_roll_joint")
)

KNEES_BENT_KEYFRAME = EntityCfg.InitialStateCfg(
  pos=(0, 0, 0.73),
  joint_pos={
    "left_hip_pitch_joint": 0.2,
    "right_hip_pitch_joint": -0.2,  # mirrored axis
    ".*_hip_roll_joint": 0.0,
    ".*_hip_yaw_joint": 0.0,
    "left_knee_joint": -0.4,  # left axis (0,-1,0): negative extends back
    "right_knee_joint": 0.4,  # right axis (0,1,0): positive extends back
    "left_ankle_pitch_joint": -0.25,
    "right_ankle_pitch_joint": 0.25,
    ".*_ankle_roll_joint": 0.0,
  },
  joint_vel={".*": 0.0},
)

ASIMOV_ARTICULATION = EntityArticulationInfoCfg(
  actuators=(
    ASIMOV_ACTUATOR_HIP_PITCH_YAW,
    ASIMOV_ACTUATOR_HIP_ROLL_KNEE,
    ASIMOV_ACTUATOR_ANKLE,
  ),
  soft_joint_pos_limit_factor=0.9,
)

# 0.3 multiplier (vs G1's 0.25): more responsive control on the lighter robot.
ASIMOV_ACTION_SCALE = action_scale_from_articulation(ASIMOV_ARTICULATION, factor=0.3)


def get_asimov_robot_cfg() -> EntityCfg:
  """Fresh Asimov EntityCfg (a new instance per call)."""
  return EntityCfg(
    init_state=copy.deepcopy(KNEES_BENT_KEYFRAME),
    articulation=ASIMOV_ARTICULATION,
  )
