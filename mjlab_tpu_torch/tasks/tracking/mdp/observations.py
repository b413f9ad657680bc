"""Tracking-task observations: the motion's anchor and the robot's bodies in
the robot's anchor frame (port of mjlab_tpu/tasks/tracking/mdp/observations.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.core import math as mt


def _anchor_to_motion(env, command_name: str):
  command = env.command_manager.get_term(command_name)
  return mt.subtract_frame_transforms(
    command.robot_anchor_pos_w, command.robot_anchor_quat_w,
    command.anchor_pos_w, command.anchor_quat_w,
  )


def _anchor_to_bodies(env, command_name: str):
  command = env.command_manager.get_term(command_name)
  nb = len(command.cfg.body_names)
  anchor_pos = command.robot_anchor_pos_w[:, None, :].expand(-1, nb, -1)
  anchor_quat = command.robot_anchor_quat_w[:, None, :].expand(-1, nb, -1)
  return mt.subtract_frame_transforms(
    anchor_pos, anchor_quat, command.robot_body_pos_w, command.robot_body_quat_w
  )


def _first_two_columns(quat: torch.Tensor, num_envs: int) -> torch.Tensor:
  return mt.quat_to_mat(quat)[..., :2].reshape(num_envs, -1)


def motion_anchor_pos_b(env, command_name: str) -> torch.Tensor:
  pos, _ = _anchor_to_motion(env, command_name)
  return pos.reshape(env.num_envs, -1)


def motion_anchor_ori_b(env, command_name: str) -> torch.Tensor:
  _, ori = _anchor_to_motion(env, command_name)
  return _first_two_columns(ori, env.num_envs)


def robot_body_pos_b(env, command_name: str) -> torch.Tensor:
  pos, _ = _anchor_to_bodies(env, command_name)
  return pos.reshape(env.num_envs, -1)


def robot_body_ori_b(env, command_name: str) -> torch.Tensor:
  _, ori = _anchor_to_bodies(env, command_name)
  return _first_two_columns(ori, env.num_envs)
