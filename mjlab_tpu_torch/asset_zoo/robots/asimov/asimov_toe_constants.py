"""Asimov-Toe biped constants as data (port of the numbers of
mjlab_tpu/asset_zoo/robots/asimov/asimov_toe_constants.py).

The toe variant's ankles are driven by two tendon position actuators per
foot (left/right_ankle_A/B, kp 300, compiled from the XML into the scene
npz), which `AnklePrToTendonAction` targets. The joint actuators here cover
the hips, the knees and the passive-spring toes; their effort limits are
the encos current limits.
"""

from __future__ import annotations

import copy

from mjlab_tpu_torch.asset_zoo.robots import action_scale_from_articulation
from mjlab_tpu_torch.asset_zoo.robots.unitree_motors import MOTOR_7520_14, MOTOR_7520_22
from mjlab_tpu_torch.entity import EntityArticulationInfoCfg, EntityCfg
from mjlab_tpu_torch.utils.spec_config import ActuatorCfg

NATURAL_FREQ_HZ = 8.0
DAMPING_RATIO = 1.8


def _actuator_cfg(
  motor, joint_names_expr: tuple[str, ...], effort_limit: float
) -> ActuatorCfg:
  kp, kd = motor.pd_gains(NATURAL_FREQ_HZ, DAMPING_RATIO)
  return ActuatorCfg(
    joint_names_expr=joint_names_expr,
    effort_limit=effort_limit,
    armature=motor.reflected_inertia,
    stiffness=kp,
    damping=kd,
  )


ASIMOV_ACTUATOR_HIP_PITCH = _actuator_cfg(
  MOTOR_7520_14, (".*_hip_pitch_joint",), effort_limit=55.0
)
ASIMOV_ACTUATOR_HIP_ROLL = _actuator_cfg(
  MOTOR_7520_22, (".*_hip_roll_joint",), effort_limit=90.0
)
ASIMOV_ACTUATOR_HIP_YAW = _actuator_cfg(
  MOTOR_7520_14, (".*_hip_yaw_joint",), effort_limit=60.0
)
ASIMOV_ACTUATOR_KNEE = _actuator_cfg(
  MOTOR_7520_22, (".*_knee_joint",), effort_limit=50.0
)

# Toes: a passive spring with low control authority (URDF spring/damping).
ASIMOV_TOE_ACTUATOR = ActuatorCfg(
  joint_names_expr=("left_toe_joint", "right_toe_joint"),
  effort_limit=5.0,
  armature=0.0001,
  stiffness=50.0,
  damping=0.8,
)

# Mirrored axes, hardware-corrected signs: the left knee axis (0,1,0)
# extends back with a positive angle, the right with a negative one.
KNEES_BENT_KEYFRAME = EntityCfg.InitialStateCfg(
  pos=(0, 0, 0.73),
  joint_pos={
    "left_hip_pitch_joint": 0.2,
    "right_hip_pitch_joint": -0.2,
    ".*_hip_roll_joint": 0.0,
    ".*_hip_yaw_joint": 0.0,
    "left_knee_joint": 0.4,
    "right_knee_joint": -0.4,
    "left_ankle_pitch_joint": -0.25,
    "right_ankle_pitch_joint": 0.25,
    ".*_ankle_roll_joint": 0.0,
    ".*_toe_joint": 0.0,
  },
  joint_vel={".*": 0.0},
)

ASIMOV_ARTICULATION = EntityArticulationInfoCfg(
  actuators=(
    ASIMOV_ACTUATOR_HIP_PITCH,
    ASIMOV_ACTUATOR_HIP_ROLL,
    ASIMOV_ACTUATOR_HIP_YAW,
    ASIMOV_ACTUATOR_KNEE,
    ASIMOV_TOE_ACTUATOR,
  ),
  soft_joint_pos_limit_factor=0.9,
)

ASIMOV_ACTION_SCALE = action_scale_from_articulation(ASIMOV_ARTICULATION, factor=0.25)


def get_asimov_robot_cfg() -> EntityCfg:
  """Fresh Asimov-Toe EntityCfg (a new instance per call)."""
  return EntityCfg(
    init_state=copy.deepcopy(KNEES_BENT_KEYFRAME),
    articulation=ASIMOV_ARTICULATION,
  )
