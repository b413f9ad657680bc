"""Stock reward terms (port of mjlab_tpu/envs/mdp/rewards.py)."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.core.strings import resolve_matching_names_values
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def is_alive(env) -> torch.Tensor:
  return (~env.termination_manager.terminated).to(env.dtype)


def is_terminated(env) -> torch.Tensor:
  return env.termination_manager.terminated.to(env.dtype)


def joint_torques_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  return torch.sum(torch.square(asset.data.actuator_force), dim=1)


def joint_acc_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  return torch.sum(torch.square(asset.data.joint_acc[:, asset_cfg.joint_ids]), dim=1)


def joint_vel_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  return torch.sum(torch.square(asset.data.joint_vel[:, asset_cfg.joint_ids]), dim=1)


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


class posture:
  """Exp-kernel posture reward with a per-joint std, resolved once from the
  cfg's regex dict."""

  def __init__(self, cfg, env):
    asset = env.scene[cfg.params["asset_cfg"].name]
    self.default_joint_pos = asset.data.default_joint_pos
    _, joint_names = asset.find_joints(cfg.params["asset_cfg"].joint_names)
    _, _, std = resolve_matching_names_values(
      data=cfg.params["std"], list_of_strings=joint_names
    )
    self.std = torch.as_tensor(std, dtype=env.dtype, device=env.device)

  def __call__(self, env, std, asset_cfg: SceneEntityCfg) -> torch.Tensor:
    del std
    asset = env.scene[asset_cfg.name]
    q = asset.data.joint_pos[:, asset_cfg.joint_ids]
    q0 = self.default_joint_pos[:, asset_cfg.joint_ids]
    err2 = torch.square(q - q0)
    return torch.exp(-torch.mean(err2 / self.std**2, dim=1))


def electrical_power_cost(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  mech = asset.data.actuator_force * asset.data.joint_vel
  return torch.sum(torch.clamp(mech, min=0.0), dim=1)


def flat_orientation_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
  asset = env.scene[asset_cfg.name]
  return torch.sum(torch.square(asset.data.projected_gravity_b[:, :2]), dim=1)
