"""Actuator configuration (the `ActuatorCfg` of mjlab_tpu/utils/spec_config.py).

The port composes no MjSpec: scenes arrive compiled, with the actuators'
gains already in the model. `ActuatorCfg` stays as data, for the action
scales the task derives from it and for the articulation's record."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ActuatorCfg:
  """PD position actuator parameters for regex-matched joints."""

  joint_names_expr: tuple[str, ...]
  effort_limit: float
  stiffness: float
  damping: float
  frictionloss: float = 0.0
  armature: float = 0.0
