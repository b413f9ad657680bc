"""Velocity-task terminations (port of
mjlab_tpu/tasks/velocity/mdp/terminations.py)."""

from __future__ import annotations

import torch


def illegal_contact(env, sensor_name: str) -> torch.Tensor:
  """Terminate when the given contact sensor reports any contact."""
  return torch.any(env.scene[sensor_name].data.found > 0, dim=-1)
