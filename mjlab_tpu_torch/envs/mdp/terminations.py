"""Stock termination terms (port of mjlab_tpu/envs/mdp/terminations.py)."""

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


def root_height_below_minimum(
  env, minimum_height: float, asset_cfg: SceneEntityCfg = _DEFAULT
) -> torch.Tensor:
  return env.scene[asset_cfg.name].data.root_link_pos_w[:, 2] < minimum_height


def nan_detection(env) -> torch.Tensor:
  """Flag the envs whose qpos, qvel or qacc holds a NaN or an infinity."""
  d = env.data
  bad_q = ~torch.isfinite(d.qpos).all(dim=-1)
  bad_v = ~torch.isfinite(d.qvel).all(dim=-1)
  bad_a = ~torch.isfinite(d.qacc).all(dim=-1)
  return bad_q | bad_v | bad_a
