"""Stock termination terms the G1 velocity task names (port of
mjlab_tpu/envs/mdp/terminations.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def time_out(env) -> torch.Tensor:
  return env.episode_length_buf >= env.max_episode_length


def bad_orientation(
  env, limit_angle: float, asset_cfg: SceneEntityCfg = _DEFAULT
) -> torch.Tensor:
  g = env.scene[asset_cfg.name].data.projected_gravity_b
  return torch.abs(torch.arccos(torch.clamp(-g[:, 2], -1.0, 1.0))) > limit_angle

