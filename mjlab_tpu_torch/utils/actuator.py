"""Electric actuator modeling helpers; a copy of mjlab_tpu/utils/actuator.py.

Reflected-inertia derivations for geared electric actuators (reference
utils/actuator.py:16-33). A gearbox multiplies rotor inertia by the square
of the downstream gear ratio when reflected to the output shaft.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class ElectricActuator:
  """Output-shaft parameters of a geared electric actuator."""

  reflected_inertia: float
  velocity_limit: float
  effort_limit: float

  def pd_gains(
    self, natural_freq_hz: float, damping_ratio: float
  ) -> tuple[float, float]:
    """Critically-tuned PD gains from a target closed-loop natural frequency.

    kp = J·ω², kd = 2ζJω for a unit-inertia second-order system with the
    actuator's reflected inertia J (reference g1_constants.py:120-131).
    """
    w = 2.0 * math.pi * natural_freq_hz
    j = self.reflected_inertia
    return j * w * w, 2.0 * damping_ratio * j * w

  def scaled(self, factor: float) -> "ElectricActuator":
    """N identical actuators acting in parallel on one joint (e.g. 4-bar
    linkage ankles, reference g1_constants.py:168-186)."""
    return ElectricActuator(
      reflected_inertia=self.reflected_inertia * factor,
      velocity_limit=self.velocity_limit,
      effort_limit=self.effort_limit * factor,
    )


def reflected_inertia(rotor_inertia: float, gear_ratio: float) -> float:
  """Reflected inertia of a single-stage gearbox."""
  return rotor_inertia * gear_ratio**2


def reflected_inertia_from_two_stage_planetary(
  rotor_inertia: tuple[float, float, float],
  gear_ratio: tuple[float, float, float],
) -> float:
  """Reflected inertia of a two-stage planetary gearbox.

  Stage inertias are reflected through the product of all downstream ratios
  (reference utils/actuator.py:24-33). gear_ratio[0] is the rotor itself
  and must be 1.
  """
  if gear_ratio[0] != 1:
    raise ValueError("rotor stage gear ratio must be 1")
  j0, j1, j2 = rotor_inertia
  _, g1, g2 = gear_ratio
  return j0 * (g1 * g2) ** 2 + j1 * g2**2 + j2


def rpm_to_rad(rpm: float) -> float:
  return rpm * 2.0 * math.pi / 60.0
