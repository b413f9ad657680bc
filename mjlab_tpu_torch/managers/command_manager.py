"""Command manager (port of mjlab_tpu/managers/command_manager.py): per-env
commands resampled on a clock (`_resample_command` on expired clocks and at
reset, `_update_command` every step, `_update_metrics`), metrics surfaced as
Metrics/<term>/<metric> at reset. Every update is masked."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg


class CommandTerm(ManagerTermBase):
  """Stateful command term. Subclasses implement the command property and
  the _resample/_update hooks on their state dict."""

  @property
  def state(self) -> dict:
    return self._env.ns("command")[self._term_name]

  @property
  def command(self) -> torch.Tensor:
    raise NotImplementedError

  def init_state(self) -> dict:
    env = self._env
    return {
      "time_left": torch.zeros(self.num_envs, dtype=env.dtype, device=env.device),
      "metrics": self._init_metrics(),
      **self._init_term_state(),
    }

  def _init_metrics(self) -> dict:
    return {}

  def _init_term_state(self) -> dict:
    return {}

  def _resample_command(self, env_mask) -> None:
    raise NotImplementedError

  def _update_command(self) -> None:
    pass

  def _update_metrics(self) -> None:
    pass

  def _resample_time(self, env_mask) -> None:
    lo, hi = self.cfg.resampling_time_range
    env = self._env
    u = torch.rand(self.num_envs, generator=env.generator, dtype=env.dtype,
                   device=env.device)
    self.state["time_left"] = torch.where(env_mask, lo + u * (hi - lo),
                                          self.state["time_left"])

  def compute(self, dt: float) -> None:
    st = self.state
    st["time_left"] = st["time_left"] - dt
    expired = st["time_left"] <= 0.0
    self._resample_time(expired)
    self._resample_command(expired)
    self._update_command()
    self._update_metrics()

  def reset(self, env_mask=None) -> dict:
    if env_mask is None:
      env_mask = torch.ones(self.num_envs, dtype=torch.bool, device=self._env.device)
    self._resample_time(env_mask)
    self._resample_command(env_mask)
    self._update_command()
    metrics = {}
    for name, value in self.state["metrics"].items():
      metrics[name] = torch.sum(torch.where(env_mask, value, 0.0))
      self.state["metrics"][name] = torch.where(env_mask, 0.0, value)
    return metrics


class CommandManager(ManagerBase):
  NS = "command"

  def __init__(self, cfg: dict[str, CommandTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._terms: dict[str, CommandTerm] = {}
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      assert term_cfg.class_type is not None
      term = term_cfg.class_type(term_cfg, self._env)
      term._term_name = name
      self._terms[name] = term

  @property
  def active_terms(self) -> list[str]:
    return list(self._terms)

  def init_state(self) -> dict:
    return {n: t.init_state() for n, t in self._terms.items()}

  def get_command(self, name: str) -> torch.Tensor:
    return self._terms[name].command

  def get_term(self, name: str) -> CommandTerm:
    return self._terms[name]

  def compute(self, dt: float) -> None:
    for term in self._terms.values():
      term.compute(dt)

  def reset(self, env_mask=None) -> dict:
    log = {}
    for name, term in self._terms.items():
      for metric_name, value in term.reset(env_mask).items():
        log[f"Metrics/{name}/{metric_name}"] = value
    return log


class NullCommandManager:
  """No-op command manager."""

  active_terms: list[str] = []

  def init_state(self) -> dict:
    return {}

  def get_command(self, name: str):
    raise KeyError("No command manager configured.")

  def compute(self, dt: float) -> None:
    pass

  def reset(self, env_mask=None) -> dict:
    return {}
