"""Event manager: startup / reset / interval modes (port of
mjlab_tpu/managers/event_manager.py).

Reset and interval events apply under a boolean (B,) mask; their draws are
made for every env and merged by the mask. Startup events run once at
build time. Event term signature: `func(env, env_mask, **params)`.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.distributed.sharding import env_rows

from mjlab_tpu_torch.managers.manager_base import ManagerBase
from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg


class EventManager(ManagerBase):
  NS = "event"

  def __init__(self, cfg: dict[str, EventTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._mode_terms: dict[str, list[str]] = {}
    self._terms: dict[str, EventTermCfg] = {}
    self.domain_randomization_fields: set[str] = set()
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      self._resolve_common_term_cfg(name, term_cfg)
      self._mode_terms.setdefault(term_cfg.mode, []).append(name)
      self._terms[name] = term_cfg
      if term_cfg.domain_randomization and "field" in term_cfg.params:
        self.domain_randomization_fields.add(term_cfg.params["field"])

  @property
  def available_modes(self) -> list[str]:
    return list(self._mode_terms)

  @property
  def active_terms(self) -> dict[str, list[str]]:
    return dict(self._mode_terms)

  def _uniform(self, lo: float, hi: float) -> torch.Tensor:
    env = self._env
    u = env_rows(torch.rand, (self.num_envs,), generator=env.generator, dtype=env.dtype,
                 device=env.device)
    return lo + u * (hi - lo)

  def init_state(self) -> dict:
    state: dict = {"interval_time_left": {}, "last_trigger_step": {}}
    for name in self._mode_terms.get("interval", []):
      state["interval_time_left"][name] = self._uniform(*self._terms[name].interval_range_s)
    for name in self._mode_terms.get("reset", []):
      if self._terms[name].min_step_count_between_reset > 0:
        state["last_trigger_step"][name] = torch.zeros(
          self.num_envs, dtype=torch.int32, device=self._env.device
        )
    return state

  def apply(self, mode: str, env_mask=None, dt: float | None = None,
            global_env_step_count=None) -> None:
    ns = self._env.ns(self.NS) if mode in ("interval", "reset") else None
    for name in self._mode_terms.get(mode, []):
      cfg = self._terms[name]
      if mode == "interval":
        time_left = ns["interval_time_left"][name] - dt
        fire = time_left <= 0.0
        resample = self._uniform(*cfg.interval_range_s)
        ns["interval_time_left"][name] = torch.where(fire, resample, time_left)
        cfg.func(self._env, fire, **cfg.params)
      elif mode == "reset":
        mask = env_mask
        if cfg.min_step_count_between_reset > 0 and global_env_step_count is not None:
          # Per-env trigger spacing: fire only for envs whose last trigger is
          # at least min_step_count_between_reset steps in the past.
          last = ns["last_trigger_step"][name]
          ok = (global_env_step_count - last) >= cfg.min_step_count_between_reset
          mask = mask & ok
          ns["last_trigger_step"][name] = torch.where(
            mask, global_env_step_count.to(last.dtype), last
          )
        cfg.func(self._env, mask, **cfg.params)
      elif mode == "startup":
        mask = torch.ones(self.num_envs, dtype=torch.bool, device=self._env.device)
        cfg.func(self._env, mask, **cfg.params)
      else:
        raise ValueError(f"Unknown event mode {mode}")

  def reset(self, env_mask=None) -> dict:
    return {}
