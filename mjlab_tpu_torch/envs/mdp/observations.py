"""Stock observation terms the G1 velocity task names (port of
mjlab_tpu/envs/mdp/observations.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def projected_gravity(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  return env.scene[asset_cfg.name].data.projected_gravity_b


def joint_pos_rel(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  data = env.scene[asset_cfg.name].data
  return (data.joint_pos - data.default_joint_pos)[:, asset_cfg.joint_ids]


def joint_vel_rel(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  data = env.scene[asset_cfg.name].data
  return (data.joint_vel - data.default_joint_vel)[:, asset_cfg.joint_ids]


def last_action(env, action_name: str | None = None) -> torch.Tensor:
  if action_name is None:
    return env.action_manager.action
  return env.action_manager.get_term(action_name).state["raw"]


def generated_commands(env, command_name: str) -> torch.Tensor:
  return env.command_manager.get_command(command_name)


def builtin_sensor(env, sensor_name: str) -> torch.Tensor:
  return env.scene[sensor_name].data
