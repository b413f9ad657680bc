"""Reward manager (port of mjlab_tpu/managers/reward_manager.py):
reward = Σ term(env, **params) · weight · dt. Zero-weight terms are
dropped; per-term episodic sums are kept and surfaced (summed over the
resetting envs) in the reset log as Episode_Reward/<name>."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase
from mjlab_tpu_torch.managers.manager_term_config import RewardTermCfg


class RewardManager(ManagerBase):
  NS = "reward"

  def __init__(self, cfg: dict[str, RewardTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._term_names: list[str] = []
    self._term_cfgs: list[RewardTermCfg] = []
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      self._resolve_common_term_cfg(name, term_cfg)
      if term_cfg.weight == 0.0:
        continue
      if isinstance(term_cfg.func, ManagerTermBase):
        term_cfg.func.NS = self.NS
        term_cfg.func._term_name = name
      self._term_names.append(name)
      self._term_cfgs.append(term_cfg)

  @property
  def active_terms(self) -> list[str]:
    return list(self._term_names)

  def init_state(self) -> dict:
    B, dtype, dev = self.num_envs, self._env.dtype, self._env.device
    term_state = {}
    for name, cfg in zip(self._term_names, self._term_cfgs):
      if isinstance(cfg.func, ManagerTermBase):
        term_state[name] = cfg.func.init_state()
    return {
      "episode_sums": {
        n: torch.zeros(B, dtype=dtype, device=dev) for n in self._term_names
      },
      # Weights as state, so that a curriculum can stage them.
      "weights": {
        n: torch.full((), c.weight, dtype=dtype, device=dev)
        for n, c in zip(self._term_names, self._term_cfgs)
      },
      "term_state": term_state,
    }

  def compute(self, dt: float) -> torch.Tensor:
    ns = self._env.ns(self.NS)
    total = torch.zeros(self.num_envs, dtype=self._env.dtype, device=self._env.device)
    for name, cfg in zip(self._term_names, self._term_cfgs):
      value = cfg.func(self._env, **cfg.params) * ns["weights"][name] * dt
      total = total + value
      ns["episode_sums"][name] = ns["episode_sums"][name] + value
    return total

  def reset(self, env_mask=None) -> dict:
    """Clear episodic sums of the masked envs; return the per-term sums
    over the resetting envs for logging."""
    ns = self._env.ns(self.NS)
    log = {}
    for cfg in self._term_cfgs:
      if isinstance(cfg.func, ManagerTermBase):
        cfg.func.reset(env_mask)
    for name in self._term_names:
      sums = ns["episode_sums"][name]
      if env_mask is None:
        log[f"Episode_Reward/{name}"] = torch.sum(sums)
        ns["episode_sums"][name] = torch.zeros_like(sums)
      else:
        log[f"Episode_Reward/{name}"] = torch.sum(torch.where(env_mask, sums, 0.0))
        ns["episode_sums"][name] = torch.where(env_mask, 0.0, sums)
    return log
