"""Curriculum manager (port of mjlab_tpu/managers/curriculum_manager.py):
runs curriculum terms at reset time; a term is
`func(env, env_mask, **params) -> value, dict or None`, and its values are
kept as 0-d tensors and logged as Curriculum/<name>."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase
from mjlab_tpu_torch.managers.manager_term_config import CurriculumTermCfg


class CurriculumManager(ManagerBase):
  NS = "curriculum"

  def __init__(self, cfg: dict[str, CurriculumTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._term_names: list[str] = []
    self._term_cfgs: list[CurriculumTermCfg] = []
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      self._resolve_common_term_cfg(name, term_cfg)
      if isinstance(term_cfg.func, ManagerTermBase):
        term_cfg.func.NS = self.NS
        term_cfg.func._term_name = name
      self._term_names.append(name)
      self._term_cfgs.append(term_cfg)

  @property
  def active_terms(self) -> list[str]:
    return list(self._term_names)

  def init_state(self) -> dict:
    values: dict = {}
    env = self._env
    for name, cfg in zip(self._term_names, self._term_cfgs):
      keys = getattr(cfg.func, "metric_keys", None)
      for key in ([f"{name}/{k}" for k in keys] if keys else [name]):
        values[key] = torch.zeros((), dtype=env.dtype, device=env.device)
    return {"values": values}

  def compute(self, env_mask=None) -> None:
    ns = self._env.ns(self.NS)
    for name, cfg in zip(self._term_names, self._term_cfgs):
      value = cfg.func(self._env, env_mask, **cfg.params)
      if isinstance(value, dict):
        for k, v in value.items():
          ns["values"][f"{name}/{k}"] = v.to(self._env.dtype)
      elif value is not None:
        ns["values"][name] = value.to(self._env.dtype)

  def reset(self, env_mask=None) -> dict:
    ns = self._env.ns(self.NS)
    return {f"Curriculum/{k}": v for k, v in ns["values"].items()}


class NullCurriculumManager:
  active_terms: list[str] = []

  def init_state(self) -> dict:
    return {}

  def compute(self, env_mask=None) -> None:
    pass

  def reset(self, env_mask=None) -> dict:
    return {}
