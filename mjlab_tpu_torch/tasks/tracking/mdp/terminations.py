"""Tracking-task terminations: anchor and body deviation limits (port of
mjlab_tpu/tasks/tracking/mdp/terminations.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.tasks.tracking.mdp.rewards import _get_body_indexes


def bad_anchor_pos(env, command_name: str, threshold: float) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  return torch.linalg.vector_norm(
    command.anchor_pos_w - command.robot_anchor_pos_w, dim=1
  ) > threshold


def bad_anchor_pos_z_only(env, command_name: str, threshold: float) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  return torch.abs(command.anchor_pos_w[:, -1] - command.robot_anchor_pos_w[:, -1]) > threshold


def bad_anchor_ori(env, asset_cfg: SceneEntityCfg, command_name: str,
                   threshold: float) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  command = env.command_manager.get_term(command_name)
  motion_grav_b = mt.quat_apply_inverse(command.anchor_quat_w, asset.data.gravity_vec_w)
  robot_grav_b = mt.quat_apply_inverse(command.robot_anchor_quat_w, asset.data.gravity_vec_w)
  return torch.abs(motion_grav_b[:, 2] - robot_grav_b[:, 2]) > threshold


def bad_motion_body_pos(env, command_name: str, threshold: float,
                        body_names: tuple[str, ...] | None = None) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = torch.linalg.vector_norm(
    command.body_pos_relative_w[:, idx] - command.robot_body_pos_w[:, idx], dim=-1
  )
  return torch.any(error > threshold, dim=-1)


def bad_motion_body_pos_z_only(env, command_name: str, threshold: float,
                               body_names: tuple[str, ...] | None = None) -> torch.Tensor:
  command = env.command_manager.get_term(command_name)
  idx = _get_body_indexes(command, body_names)
  error = torch.abs(
    command.body_pos_relative_w[:, idx, -1] - command.robot_body_pos_w[:, idx, -1]
  )
  return torch.any(error > threshold, dim=-1)
