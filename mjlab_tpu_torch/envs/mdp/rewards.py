"""Stock reward terms the G1 velocity task names (port of
mjlab_tpu/envs/mdp/rewards.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def action_rate_l2(env) -> torch.Tensor:
  am = env.action_manager
  return torch.sum(torch.square(am.action - am.prev_action), dim=1)


def joint_pos_limits(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  soft = asset.data.soft_joint_pos_limits[:, asset_cfg.joint_ids]
  q = asset.data.joint_pos[:, asset_cfg.joint_ids]
  out = -torch.clamp(q - soft[..., 0], max=0.0)
  out = out + torch.clamp(q - soft[..., 1], min=0.0)
  return torch.sum(out, dim=1)
