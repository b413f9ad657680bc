"""Velocity-task reward terms (port of
mjlab_tpu/tasks/velocity/mdp/rewards.py): exp-kernel velocity tracking,
posture by speed regime, gait shaping (air time, clearance, swing height,
slip, soft landing) and whole-body penalties. Step metrics go to
env.step_log."""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.core.strings import resolve_matching_names_values
from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.manager_term_config import RewardTermCfg
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT_ASSET_CFG = SceneEntityCfg("robot")


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def _command_activation(env, command_name, command_threshold):
  """1.0 where |command| exceeds the threshold, else 0.0."""
  command = env.command_manager.get_command(command_name)
  total = _norm(command[:, :2]) + torch.abs(command[:, 2])
  return (total > command_threshold).to(env.dtype)


def track_linear_velocity(env, std: float, command_name: str,
                          asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  """Exp-kernel tracking of the commanded base-frame linear velocity."""
  command = env.command_manager.get_command(command_name)
  actual = env.scene[asset_cfg.name].data.root_link_lin_vel_b
  xy_error = torch.sum(torch.square(command[:, :2] - actual[:, :2]), dim=1)
  z_error = torch.square(actual[:, 2])
  return torch.exp(-(xy_error + z_error) / std**2)


def track_angular_velocity(env, std: float, command_name: str,
                           asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  """Exp-kernel tracking of the commanded yaw rate."""
  command = env.command_manager.get_command(command_name)
  actual = env.scene[asset_cfg.name].data.root_link_ang_vel_b
  z_error = torch.square(command[:, 2] - actual[:, 2])
  xy_error = torch.sum(torch.square(actual[:, :2]), dim=1)
  return torch.exp(-(z_error + xy_error) / std**2)


def flat_orientation(env, std: float, asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  """Exp-kernel uprightness of one body (the root when no body is named)."""
  asset = env.scene[asset_cfg.name]
  if isinstance(asset_cfg.body_ids, slice):
    gravity_b = asset.data.projected_gravity_b
  else:
    body_quat_w = asset.data.body_link_quat_w[:, asset_cfg.body_ids, :][:, 0]
    gravity_b = mt.quat_apply_inverse(body_quat_w, asset.data.gravity_vec_w)
  xy_sq = torch.sum(torch.square(gravity_b[:, :2]), dim=1)
  return torch.exp(-xy_sq / std**2)


def self_collision_cost(env, sensor_name: str):
  """Number of self-collisions found by the contact sensor."""
  return env.scene[sensor_name].data.found[:, 0].to(env.dtype)


def body_angular_velocity_penalty(env, asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  ang_vel = env.scene[asset_cfg.name].data.body_link_ang_vel_w[:, asset_cfg.body_ids, :][:, 0]
  return torch.sum(torch.square(ang_vel[:, :2]), dim=1)


def angular_momentum_penalty(env, sensor_name: str):
  """Penalize whole-body angular momentum."""
  angmom = env.scene[sensor_name].data
  mag_sq = torch.sum(torch.square(angmom), dim=-1)
  env.step_log["Metrics/angular_momentum_mean"] = torch.mean(torch.sqrt(mag_sq))
  return mag_sq


def feet_air_time(env, sensor_name: str, threshold_min: float = 0.05,
                  threshold_max: float = 0.5, command_name: str | None = None,
                  command_threshold: float = 0.5):
  """Reward feet spending time in [threshold_min, threshold_max] air windows."""
  air = env.scene[sensor_name].data.current_air_time
  in_range = (air > threshold_min) & (air < threshold_max)
  reward = torch.sum(in_range.to(env.dtype), dim=1)
  in_air = (air > 0).to(env.dtype)
  env.step_log["Metrics/air_time_mean"] = torch.sum(air * in_air) / torch.clamp(
    torch.sum(in_air), min=1
  )
  if command_name is not None:
    reward = reward * _command_activation(env, command_name, command_threshold)
  return reward


def feet_clearance(env, target_height: float, command_name: str | None = None,
                   command_threshold: float = 0.01,
                   asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  """Penalize clearance error weighted by horizontal foot speed."""
  data = env.scene[asset_cfg.name].data
  foot_z = data.site_pos_w[:, asset_cfg.site_ids, 2]
  vel_norm = _norm(data.site_lin_vel_w[:, asset_cfg.site_ids, :2])
  cost = torch.sum(torch.abs(foot_z - target_height) * vel_norm, dim=1)
  if command_name is not None:
    cost = cost * _command_activation(env, command_name, command_threshold)
  return cost


class feet_swing_height(ManagerTermBase):
  """Penalize the peak swing-height error, evaluated at landing. Stateful:
  tracks each foot's peak height while airborne."""

  def init_state(self) -> dict:
    n_sites = len(self.cfg.params["asset_cfg"].site_ids)
    env = self._env
    return {"peak_heights": torch.zeros((self.num_envs, n_sites), dtype=env.dtype,
                                        device=env.device)}

  def __call__(self, env, sensor_name: str, target_height: float, command_name: str,
               command_threshold: float, asset_cfg: SceneEntityCfg):
    contact_sensor = env.scene[sensor_name]
    foot_heights = env.scene[asset_cfg.name].data.site_pos_w[:, asset_cfg.site_ids, 2]
    in_air = contact_sensor.data.found == 0
    peaks = torch.where(in_air, torch.maximum(self.state["peak_heights"], foot_heights),
                        self.state["peak_heights"])
    first_contact = contact_sensor.compute_first_contact(dt=env.step_dt)
    active = _command_activation(env, command_name, command_threshold)
    error = peaks / target_height - 1.0
    fc = first_contact.to(env.dtype)
    cost = torch.sum(torch.square(error) * fc, dim=1) * active
    env.step_log["Metrics/peak_height_mean"] = torch.sum(peaks * fc) / torch.clamp(
      torch.sum(fc), min=1
    )
    self.state["peak_heights"] = torch.where(first_contact, 0.0, peaks)
    return cost


def feet_slip(env, sensor_name: str, command_name: str, command_threshold: float = 0.01,
              asset_cfg: SceneEntityCfg = _DEFAULT_ASSET_CFG):
  """Penalize squared horizontal foot speed while in contact."""
  active = _command_activation(env, command_name, command_threshold)
  in_contact = (env.scene[sensor_name].data.found > 0).to(env.dtype)
  vel_norm = _norm(env.scene[asset_cfg.name].data.site_lin_vel_w[:, asset_cfg.site_ids, :2])
  cost = torch.sum(torch.square(vel_norm) * in_contact, dim=1) * active
  env.step_log["Metrics/slip_velocity_mean"] = torch.sum(
    vel_norm * in_contact
  ) / torch.clamp(torch.sum(in_contact), min=1)
  return cost


def soft_landing(env, sensor_name: str, command_name: str | None = None,
                 command_threshold: float = 0.05):
  """Penalize the impact force magnitude at first contact."""
  contact_sensor = env.scene[sensor_name]
  force_mag = _norm(contact_sensor.data.force)
  fc = contact_sensor.compute_first_contact(dt=env.step_dt).to(env.dtype)
  landing_impact = force_mag * fc
  cost = torch.sum(landing_impact, dim=1)
  env.step_log["Metrics/landing_force_mean"] = torch.sum(landing_impact) / torch.clamp(
    torch.sum(fc), min=1
  )
  if command_name is not None:
    cost = cost * _command_activation(env, command_name, command_threshold)
  return cost


class variable_posture(ManagerTermBase):
  """Exp-kernel posture reward with per-joint stds by speed regime
  (standing / walking / running)."""

  def __init__(self, cfg: RewardTermCfg, env):
    super().__init__(cfg, env)
    asset = env.scene[cfg.params["asset_cfg"].name]
    self.default_joint_pos = asset.data.default_joint_pos
    _, joint_names = asset.find_joints(cfg.params["asset_cfg"].joint_names)
    stds = []
    for key in ("std_standing", "std_walking", "std_running"):
      _, _, values = resolve_matching_names_values(
        data=cfg.params[key], list_of_strings=joint_names
      )
      stds.append(torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=env.dtype,
                                  device=env.device))
    self.std_standing, self.std_walking, self.std_running = stds

  def __call__(self, env, std_standing, std_walking, std_running,
               asset_cfg: SceneEntityCfg, command_name: str,
               walking_threshold: float = 0.5, running_threshold: float = 1.5):
    del std_standing, std_walking, std_running  # resolved in __init__
    command = env.command_manager.get_command(command_name)
    total_speed = _norm(command[:, :2]) + torch.abs(command[:, 2])
    std = torch.where(
      (total_speed < walking_threshold)[:, None],
      self.std_standing,
      torch.where((total_speed < running_threshold)[:, None], self.std_walking,
                  self.std_running),
    )
    q = env.scene[asset_cfg.name].data.joint_pos[:, asset_cfg.joint_ids]
    q0 = self.default_joint_pos[:, asset_cfg.joint_ids]
    return torch.exp(-torch.mean(torch.square(q - q0) / torch.square(std), dim=1))
