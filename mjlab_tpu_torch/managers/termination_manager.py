"""Termination manager (port of mjlab_tpu/managers/termination_manager.py):
ORs term outputs into terminated vs time-outs; Episode_Termination/<name>
counts are logged at reset."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase
from mjlab_tpu_torch.managers.manager_term_config import TerminationTermCfg


class TerminationManager(ManagerBase):
  NS = "termination"

  def __init__(self, cfg: dict[str, TerminationTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._term_names: list[str] = []
    self._term_cfgs: list[TerminationTermCfg] = []
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      self._resolve_common_term_cfg(name, term_cfg)
      self._term_names.append(name)
      self._term_cfgs.append(term_cfg)

  @property
  def active_terms(self) -> list[str]:
    return list(self._term_names)

  def init_state(self) -> dict:
    def z():
      return torch.zeros(self.num_envs, dtype=torch.bool, device=self._env.device)

    return {
      "terminated": z(),
      "time_outs": z(),
      "episode_counts": {n: z() for n in self._term_names},
    }

  @property
  def terminated(self):
    return self._env.ns(self.NS)["terminated"]

  @property
  def time_outs(self):
    return self._env.ns(self.NS)["time_outs"]

  def compute(self) -> torch.Tensor:
    ns = self._env.ns(self.NS)
    terminated = torch.zeros(self.num_envs, dtype=torch.bool, device=self._env.device)
    time_outs = torch.zeros_like(terminated)
    for name, cfg in zip(self._term_names, self._term_cfgs):
      value = cfg.func(self._env, **cfg.params).to(torch.bool)
      ns["episode_counts"][name] = value
      if cfg.time_out:
        time_outs = time_outs | value
      else:
        terminated = terminated | value
    ns["terminated"] = terminated
    ns["time_outs"] = time_outs
    return terminated | time_outs

  def reset(self, env_mask=None) -> dict:
    ns = self._env.ns(self.NS)
    log = {}
    for name in self._term_names:
      v = ns["episode_counts"][name]
      if env_mask is not None:
        v = v & env_mask
      log[f"Episode_Termination/{name}"] = torch.sum(v.to(torch.int32))
    return log
