"""Velocity-task privileged (critic) observation terms (port of
mjlab_tpu/tasks/velocity/mdp/observations.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT_ASSET_CFG = SceneEntityCfg("robot")


def foot_height(env, asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG) -> torch.Tensor:
  return env.scene[asset_cfg.name].data.site_pos_w[:, asset_cfg.site_ids, 2]


def foot_air_time(env, sensor_name: str) -> torch.Tensor:
  return env.scene[sensor_name].data.current_air_time


def foot_contact(env, sensor_name: str) -> torch.Tensor:
  return (env.scene[sensor_name].data.found > 0).to(env.dtype)


def foot_contact_forces(env, sensor_name: str) -> torch.Tensor:
  forces = env.scene[sensor_name].data.force
  flat = forces.reshape(forces.shape[0], -1)
  return torch.sign(flat) * torch.log1p(torch.abs(flat))
