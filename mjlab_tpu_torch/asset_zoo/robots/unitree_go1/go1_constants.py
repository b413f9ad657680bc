"""Unitree Go1 (quadruped) constants as data (port of the numbers of
mjlab_tpu/asset_zoo/robots/unitree_go1/go1_constants.py).

Single-stage geared motors with 10 Hz PD tuning. The compiled gains and the
full-collision preset (condim 3, priority 1 and friction 0.6 on the feet,
condim 1 elsewhere) are already in the scene npz; these groups give the
action scales and the articulation's record.
"""

from __future__ import annotations

import copy

from mjlab_tpu_torch.asset_zoo.robots import action_scale_from_articulation
from mjlab_tpu_torch.asset_zoo.robots.unitree_motors import GO1_HIP_MOTOR, GO1_KNEE_MOTOR
from mjlab_tpu_torch.entity import EntityArticulationInfoCfg, EntityCfg
from mjlab_tpu_torch.utils.spec_config import ActuatorCfg

NATURAL_FREQ_HZ = 10.0
DAMPING_RATIO = 2.0

_HIP_KP, _HIP_KD = GO1_HIP_MOTOR.pd_gains(NATURAL_FREQ_HZ, DAMPING_RATIO)
_KNEE_KP, _KNEE_KD = GO1_KNEE_MOTOR.pd_gains(NATURAL_FREQ_HZ, DAMPING_RATIO)

GO1_HIP_ACTUATOR_CFG = ActuatorCfg(
  joint_names_expr=(".*_hip_joint", ".*_thigh_joint"),
  effort_limit=GO1_HIP_MOTOR.effort_limit,
  stiffness=_HIP_KP,
  damping=_HIP_KD,
  armature=GO1_HIP_MOTOR.reflected_inertia,
)
GO1_KNEE_ACTUATOR_CFG = ActuatorCfg(
  joint_names_expr=(".*_calf_joint",),
  effort_limit=GO1_KNEE_MOTOR.effort_limit,
  stiffness=_KNEE_KP,
  damping=_KNEE_KD,
  armature=GO1_KNEE_MOTOR.reflected_inertia,
)

INIT_STATE = EntityCfg.InitialStateCfg(
  pos=(0.0, 0.0, 0.278),
  joint_pos={
    ".*thigh_joint": 0.9,
    ".*calf_joint": -1.8,
    ".*R_hip_joint": 0.1,
    ".*L_hip_joint": -0.1,
  },
  joint_vel={".*": 0.0},
)

GO1_ARTICULATION = EntityArticulationInfoCfg(
  actuators=(GO1_HIP_ACTUATOR_CFG, GO1_KNEE_ACTUATOR_CFG),
  soft_joint_pos_limit_factor=0.9,
)

GO1_ACTION_SCALE = action_scale_from_articulation(GO1_ARTICULATION, factor=0.25)


def get_go1_robot_cfg() -> EntityCfg:
  """Fresh Go1 EntityCfg (a new instance per call)."""
  return EntityCfg(init_state=copy.deepcopy(INIT_STATE), articulation=GO1_ARTICULATION)
