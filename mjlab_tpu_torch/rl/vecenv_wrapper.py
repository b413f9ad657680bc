"""VecEnv adapter matching the reference's rsl_rl wrapper surface (port of
mjlab_tpu/rl/vecenv_wrapper.py): dict observations, combined dones,
extras["time_outs"] for bootstrapping (suppressed for finite-horizon
tasks), optional action clipping, reset-on-construct (with `seed`, which
the JAX package's wrapper does not take). OnPolicyRunner steps its env
through it, as rsl_rl's runner does."""

from __future__ import annotations

from typing import Any

import torch

from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnv


class RlVecEnvWrapper:
  def __init__(self, env: ManagerBasedRlEnv, clip_actions: float | None = None,
               seed: int | None = None):
    self.env = env
    self.clip_actions = clip_actions
    self.num_envs = self.env.num_envs
    self.num_actions = self.env.action_manager.total_action_dim
    self.max_episode_length = self.env.max_episode_length
    self.obs, _ = self.env.reset(seed=seed)

  @property
  def cfg(self) -> Any:
    return self.env.cfg

  @property
  def episode_length_buf(self):
    return self.env.episode_length_buf

  def get_observations(self):
    return self.obs

  def reset(self):
    self.obs, extras = self.env.reset()
    return self.obs, extras

  def step(self, actions):
    if self.clip_actions is not None:
      actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)
    obs, rew, terminated, time_outs, extras = self.env.step(actions)
    dones = terminated | time_outs
    self.obs = obs
    if not self.env.cfg.is_finite_horizon:
      extras["time_outs"] = time_outs
    return obs, rew, dones, extras

  def close(self):
    self.env.close()


# Reference-parity alias.
RslRlVecEnvWrapper = RlVecEnvWrapper
