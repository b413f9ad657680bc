"""Robot configuration helpers shared across the zoo."""

from __future__ import annotations

from mjlab_tpu_torch.entity import EntityArticulationInfoCfg


def action_scale_from_articulation(
  articulation: EntityArticulationInfoCfg, factor: float = 0.25
) -> dict[str, float]:
  """Per-joint-pattern action scale `factor · effort_limit / stiffness`: a
  normalized action maps to a joint-position offset whose PD response
  saturates at `factor` of the actuator's effort limit."""
  scale: dict[str, float] = {}
  for a in articulation.actuators:
    if not a.stiffness:
      continue
    for pattern in a.joint_names_expr:
      scale[pattern] = factor * a.effort_limit / a.stiffness
  return scale
