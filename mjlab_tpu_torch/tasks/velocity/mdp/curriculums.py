"""Velocity-task curriculum terms (port of
mjlab_tpu/tasks/velocity/mdp/curriculums.py). Stage selection compares the
device-side common step counter and the terrain levels move by masks, so no
step synchronizes with the host."""

from __future__ import annotations

from typing import TypedDict

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT_SCENE_CFG = SceneEntityCfg("robot")


class VelocityStage(TypedDict, total=False):
  step: int
  lin_vel_x: tuple[float, float] | None
  lin_vel_y: tuple[float, float] | None
  ang_vel_z: tuple[float, float] | None


class RewardWeightStage(TypedDict):
  step: int
  weight: float


def terrain_levels_vel(
  env, env_mask, command_name: str, asset_cfg: SceneEntityCfg = _DEFAULT_SCENE_CFG
) -> torch.Tensor:
  """Promote the masked envs whose robot walked more than half a tile from
  its origin; demote those that walked less than half the commanded
  distance (reference curriculums.py:30-64). Returns the mean level."""
  asset = env.scene[asset_cfg.name]
  terrain = env.scene.terrain
  if terrain.terrain_origins is None:
    raise ValueError("terrain_levels_vel needs a generator terrain")
  command = env.command_manager.get_command(command_name)
  distance = torch.linalg.vector_norm(
    asset.data.root_link_pos_w[:, :2] - env.scene.env_origins[:, :2], dim=1
  )
  move_up = distance > terrain.cfg.terrain_generator.size[0] / 2
  move_down = distance < (
    torch.linalg.vector_norm(command[:, :2], dim=1) * env.max_episode_length_s * 0.5
  )
  move_down = move_down & ~move_up
  terrain.update_env_origins(env_mask, move_up, move_down)
  return torch.mean(terrain.terrain_levels.to(env.dtype))


class commands_vel(ManagerTermBase):
  """Stage the command's velocity ranges by global step count; writes the
  command term's ranges in its state, where resampling reads them."""

  metric_keys = (
    "lin_vel_x_min", "lin_vel_x_max",
    "lin_vel_y_min", "lin_vel_y_max",
    "ang_vel_z_min", "ang_vel_z_max",
  )

  def __init__(self, cfg, env):
    super().__init__(cfg, env)
    # The staged ranges as device tensors, built once.
    self._staged = [
      (stage["step"], {
        key: torch.as_tensor(stage[key], dtype=env.dtype, device=env.device)
        for key in ("lin_vel_x", "lin_vel_y", "ang_vel_z")
        if stage.get(key) is not None
      })
      for stage in cfg.params["velocity_stages"]
    ]

  def __call__(self, env, env_mask, command_name: str, velocity_stages) -> dict:
    del env_mask, velocity_stages  # staged in __init__
    ranges = env.command_manager.get_term(command_name).state["ranges"]
    step = env.common_step_counter
    for stage_step, staged in self._staged:
      passed = step > stage_step
      for key, value in staged.items():
        ranges[key] = torch.where(passed, value, ranges[key])
    return {
      f"{key}_{end}": ranges[key][i]
      for key in ("lin_vel_x", "lin_vel_y", "ang_vel_z")
      for i, end in ((0, "min"), (1, "max"))
    }


class reward_weight(ManagerTermBase):
  """Stage a reward term's weight by global step count. The weight lives in
  the reward manager's state, where `RewardManager.compute` reads it."""

  metric_keys = ("weight",)

  def __call__(self, env, env_mask, reward_name: str, weight_stages) -> dict:
    del env_mask
    weights = env.ns("reward")["weights"]
    step = env.common_step_counter
    w = weights[reward_name]
    for stage in weight_stages:
      w = torch.where(step > stage["step"], torch.full_like(w, stage["weight"]), w)
    weights[reward_name] = w
    return {"weight": w}
