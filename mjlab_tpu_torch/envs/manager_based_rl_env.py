"""Manager-based RL environment (port of
mjlab_tpu/envs/manager_based_rl_env.py).

`step(action)` keeps the JAX package's order: decimated physics (apply
action → substep → scene update), episode counters, terminations, rewards,
masked in-step reset, the post-reset forward, command update, interval
events, observations. Nothing in `step` or `reset` synchronizes with the
host: resets are masks, not index lists; every branch on a device value is
a `torch.where`; constants are built at init.

The post-reset forward keeps the JAX package's semantics: when any env
resets, `forward` refreshes every env (`lax.cond(any(reset), forward,
identity)`). The port computes `forward` on every step and selects its
result with `torch.where` on the device-side `any`.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field as dc_field

import torch

from mjlab_tpu_torch import physics
from mjlab_tpu_torch.envs.manager_based_env import ManagerBasedEnv, ManagerBasedEnvCfg
from mjlab_tpu_torch.managers.command_manager import CommandManager, NullCommandManager
from mjlab_tpu_torch.managers.curriculum_manager import (
  CurriculumManager,
  NullCurriculumManager,
)
from mjlab_tpu_torch.managers.manager_term_config import (
  CommandTermCfg,
  CurriculumTermCfg,
  RewardTermCfg,
  TerminationTermCfg,
)
from mjlab_tpu_torch.managers.reward_manager import RewardManager
from mjlab_tpu_torch.managers.termination_manager import TerminationManager


@dataclass(kw_only=True)
class ManagerBasedRlEnvCfg(ManagerBasedEnvCfg):
  episode_length_s: float
  rewards: dict[str, RewardTermCfg] = dc_field(default_factory=dict)
  terminations: dict[str, TerminationTermCfg] = dc_field(default_factory=dict)
  commands: dict[str, CommandTermCfg] | None = None
  curriculum: dict[str, CurriculumTermCfg] | None = None
  is_finite_horizon: bool = False


def select_data(cond: torch.Tensor, a: physics.Data, b: physics.Data) -> physics.Data:
  """Field by field `torch.where(cond, a, b)` for a 0-d boolean `cond`."""

  def pick(x, y):
    return x if x is y else torch.where(cond, x, y)

  kw = {}
  for f in dataclasses.fields(a):
    x, y = getattr(a, f.name), getattr(b, f.name)
    if f.name == "contact":
      kw[f.name] = dataclasses.replace(x, **{
        g.name: pick(getattr(x, g.name), getattr(y, g.name))
        for g in dataclasses.fields(x)
      })
    else:
      kw[f.name] = pick(x, y)
  return a.replace(**kw)


class ManagerBasedRlEnv(ManagerBasedEnv):
  """Vectorized env. Observation and action sizes are plain attributes
  (`group_obs_dim`, `total_action_dim`); there are no gym spaces."""

  is_vector_env = True
  cfg: ManagerBasedRlEnvCfg

  def __init__(self, cfg: ManagerBasedRlEnvCfg, device=None, model=None):
    super().__init__(cfg=cfg, device=device, model=model)
    self.group_obs_dim = self.observation_manager.group_obs_dim
    self.total_action_dim = self.action_manager.total_action_dim
    self.extras: dict = {}

  @property
  def max_episode_length_s(self) -> float:
    return self.cfg.episode_length_s

  @property
  def max_episode_length(self) -> int:
    return math.ceil(self.max_episode_length_s / self.step_dt)

  def load_managers(self) -> None:
    if self.cfg.commands is not None:
      self.command_manager = CommandManager(self.cfg.commands, self)
    else:
      self.command_manager = NullCommandManager()
    super().load_managers()
    self.termination_manager = TerminationManager(self.cfg.terminations, self)
    self.reward_manager = RewardManager(self.cfg.rewards, self)
    if self.cfg.curriculum is not None:
      self.curriculum_manager = CurriculumManager(self.cfg.curriculum, self)
    else:
      self.curriculum_manager = NullCurriculumManager()

  # -- step ---------------------------------------------------------------------

  def step(self, action: torch.Tensor):
    self.step_log = {}
    self.action_manager.process_action(action)

    for _ in range(self.cfg.decimation):
      self.action_manager.apply_action()
      self.scene.write_data_to_sim()
      self._data = self.step_physics(self._data)
      self.scene.update(dt=self.physics_dt)

    self._episode_length = self._episode_length + 1
    self._common_step_counter = self._common_step_counter + 1

    reset_buf = self.termination_manager.compute()
    terminated = self.termination_manager.terminated
    time_outs = self.termination_manager.time_outs

    reward_buf = self.reward_manager.compute(dt=self.step_dt)

    log = self._reset_masked(reset_buf)
    self._data = select_data(
      torch.any(reset_buf), self.forward_physics(self._data), self._data
    )

    self.command_manager.compute(dt=self.step_dt)

    if "interval" in self.event_manager.available_modes:
      self.event_manager.apply(mode="interval", dt=self.step_dt)

    obs_buf = self.observation_manager.compute(update_history=True)

    log.update(self.step_log)
    log["reset_count"] = torch.sum(reset_buf.to(torch.int32))
    log["Metrics/physics/terrain_slots_dropped"] = torch.sum(
      self._data.ncon_dropped
    ).to(torch.float32)
    self.extras = {"log": log, "time_outs": time_outs}
    return obs_buf, reward_buf, terminated, time_outs, self.extras

  def _reset_masked(self, mask: torch.Tensor) -> dict:
    """Reset the masked envs (the JAX package's _reset_masked order)."""
    self.curriculum_manager.compute(env_mask=mask)
    self.scene.reset(mask)
    if "reset" in self.event_manager.available_modes:
      self.event_manager.apply(
        mode="reset", env_mask=mask, global_env_step_count=self._common_step_counter,
      )
    log: dict = {}
    log.update(self.observation_manager.reset(mask))
    log.update(self.action_manager.reset(mask))
    # Summed episode length of the resetting envs (× dt on the host).
    log["Episode_Length"] = torch.sum(
      torch.where(mask, self._episode_length, 0)
    ).to(self.dtype)
    log.update(self.reward_manager.reset(mask))
    log.update(self.curriculum_manager.reset(mask))
    log.update(self.command_manager.reset(mask))
    log.update(self.event_manager.reset(mask))
    log.update(self.termination_manager.reset(mask))
    self._episode_length = torch.where(mask, 0, self._episode_length)
    return log

  def reset(self, seed: int | None = None, options=None):
    del options
    if seed is not None:
      self.generator.manual_seed(seed)
    self.step_log = {}
    # Reset-time readers (curriculum terms) see the end-of-episode state.
    self._data = self.forward_physics(self._data)
    self._reset_masked(torch.ones(self.num_envs, dtype=torch.bool, device=self.device))
    self._data = self.forward_physics(self._data)
    self.command_manager.compute(dt=self.step_dt)
    obs_buf = self.observation_manager.compute(update_history=True)
    self.extras = {}
    return obs_buf, self.extras
