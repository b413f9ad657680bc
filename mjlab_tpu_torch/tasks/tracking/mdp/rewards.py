"""Tracking-task rewards: exponential kernels of motion-matching errors (port
of mjlab_tpu/tasks/tracking/mdp/rewards.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.core import math as mt


def _get_body_indexes(command, body_names: tuple[str, ...] | None):
  """The tracked bodies named in `body_names` (all when None), as an index
  the command keeps on the device."""
  return command.body_subset(body_names)


def motion_global_anchor_position_error_exp(env, command_name: str, std: float) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  error = torch.sum(torch.square(command.anchor_pos_w - command.robot_anchor_pos_w), dim=-1)
  return torch.exp(-error / std**2)


def motion_global_anchor_orientation_error_exp(env, command_name: str,
                                               std: float) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  error = mt.quat_error_magnitude(command.anchor_quat_w, command.robot_anchor_quat_w) ** 2
  return torch.exp(-error / std**2)


def motion_relative_body_position_error_exp(
  env, command_name: str, std: float, body_names: tuple[str, ...] | None = None
) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = torch.sum(
    torch.square(command.body_pos_relative_w[:, idx] - command.robot_body_pos_w[:, idx]), dim=-1
  )
  return torch.exp(-error.mean(-1) / std**2)


def motion_relative_body_orientation_error_exp(
  env, command_name: str, std: float, body_names: tuple[str, ...] | None = None
) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = mt.quat_error_magnitude(
    command.body_quat_relative_w[:, idx], command.robot_body_quat_w[:, idx]
  ) ** 2
  return torch.exp(-error.mean(-1) / std**2)


def motion_global_body_linear_velocity_error_exp(
  env, command_name: str, std: float, body_names: tuple[str, ...] | None = None
) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = torch.sum(
    torch.square(command.body_lin_vel_w[:, idx] - command.robot_body_lin_vel_w[:, idx]), dim=-1
  )
  return torch.exp(-error.mean(-1) / std**2)


def motion_global_body_angular_velocity_error_exp(
  env, command_name: str, std: float, body_names: tuple[str, ...] | None = None
) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = torch.sum(
    torch.square(command.body_ang_vel_w[:, idx] - command.robot_body_ang_vel_w[:, idx]), dim=-1
  )
  return torch.exp(-error.mean(-1) / std**2)
