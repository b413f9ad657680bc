"""Unitree motor catalog; a copy of mjlab_tpu/asset_zoo/robots/unitree_motors.py.

Published motor/gearbox specifications shared by the G1 humanoid and the
Asimov biped (same actuator series). Rotor inertias and stage ratios are
manufacturer data (reference g1_constants.py:42-118; the Go1's rotor
inertia comes from the unitree_ros URDF, go1_constants.py:39-46).
"""

from __future__ import annotations

from mjlab_tpu_torch.utils.actuator import (
  ElectricActuator,
  reflected_inertia,
  reflected_inertia_from_two_stage_planetary,
)

# -- Two-stage planetary actuators (G1 / Asimov series) --------------------

_SPECS = {
  # name: (stage rotor inertias [kg·m²], stage ratios, vel limit, effort limit)
  "5020": ((0.139e-4, 0.017e-4, 0.169e-4), (1, 1 + 46 / 18, 1 + 56 / 16), 37.0, 25.0),
  "7520_14": ((0.489e-4, 0.098e-4, 0.533e-4), (1, 4.5, 1 + 48 / 22), 32.0, 88.0),
  "7520_22": ((0.489e-4, 0.109e-4, 0.738e-4), (1, 4.5, 5), 20.0, 139.0),
  "4010": ((0.068e-4, 0.0, 0.0), (1, 5, 5), 22.0, 5.0),
}


def _make(name: str) -> ElectricActuator:
  inertias, gears, vel, eff = _SPECS[name]
  return ElectricActuator(
    reflected_inertia=reflected_inertia_from_two_stage_planetary(inertias, gears),
    velocity_limit=vel,
    effort_limit=eff,
  )


MOTOR_5020 = _make("5020")
MOTOR_7520_14 = _make("7520_14")
MOTOR_7520_22 = _make("7520_22")
MOTOR_4010 = _make("4010")

# -- Go1 single-stage actuators --------------------------------------------

GO1_ROTOR_INERTIA = 0.000111842  # Ixx from unitree_ros go1.urdf
GO1_HIP_GEAR_RATIO = 6.0
GO1_KNEE_GEAR_RATIO = GO1_HIP_GEAR_RATIO * 1.5

GO1_HIP_MOTOR = ElectricActuator(
  reflected_inertia=reflected_inertia(GO1_ROTOR_INERTIA, GO1_HIP_GEAR_RATIO),
  velocity_limit=30.1,
  effort_limit=23.7,
)
GO1_KNEE_MOTOR = ElectricActuator(
  reflected_inertia=reflected_inertia(GO1_ROTOR_INERTIA, GO1_KNEE_GEAR_RATIO),
  velocity_limit=20.06,
  effort_limit=35.55,
)
