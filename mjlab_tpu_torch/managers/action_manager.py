"""Action manager (port of mjlab_tpu/managers/action_manager.py): splits
the flat action vector across ordered ActionTerms; `process_action` once
per env step, `apply_action` every physics substep. Buffers live in the
env's "action" namespace."""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase
from mjlab_tpu_torch.managers.manager_term_config import ActionTermCfg


class ActionTerm(ManagerTermBase):
  def __init__(self, cfg: ActionTermCfg, env):
    super().__init__(cfg, env)
    self._asset = env.scene[cfg.asset_name]

  @property
  def action_dim(self) -> int:
    raise NotImplementedError

  @property
  def state(self) -> dict:
    return self._env.ns("action")["terms"][self._term_name]

  @state.setter
  def state(self, value: dict) -> None:
    self._env.ns("action")["terms"][self._term_name] = value

  def init_state(self) -> dict:
    return {}

  def process_actions(self, actions) -> None:
    raise NotImplementedError

  def apply_actions(self) -> None:
    raise NotImplementedError

  def reset(self, env_mask=None) -> None:
    pass


class ActionManager(ManagerBase):
  NS = "action"

  def __init__(self, cfg: dict[str, ActionTermCfg], env):
    self.cfg = cfg
    super().__init__(env)
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._term_names: list[str] = []
    self._terms: dict[str, ActionTerm] = {}
    for name, term_cfg in self.cfg.items():
      if term_cfg is None:
        continue
      assert term_cfg.class_type is not None, f"Action term {name} needs class_type"
      term = term_cfg.class_type(term_cfg, self._env)
      term._term_name = name
      self._term_names.append(name)
      self._terms[name] = term

  def init_state(self) -> dict:
    B, A = self.num_envs, self.total_action_dim
    z = torch.zeros((B, A), dtype=self._env.dtype, device=self._env.device)
    return {
      "action": z,
      "prev_action": z,
      "terms": {n: t.init_state() for n, t in self._terms.items()},
    }

  @property
  def total_action_dim(self) -> int:
    return sum(self.action_term_dim)

  @property
  def action_term_dim(self) -> list[int]:
    return [self._terms[n].action_dim for n in self._term_names]

  @property
  def active_terms(self) -> list[str]:
    return list(self._term_names)

  @property
  def action(self):
    return self._env.ns(self.NS)["action"]

  @property
  def prev_action(self):
    return self._env.ns(self.NS)["prev_action"]

  def get_term(self, name: str) -> ActionTerm:
    return self._terms[name]

  def process_action(self, action: torch.Tensor) -> None:
    # Cast at the env boundary: everything downstream is env.dtype.
    action = action.to(dtype=self._env.dtype)
    ns = self._env.ns(self.NS)
    ns["prev_action"] = ns["action"]
    ns["action"] = action
    idx = 0
    for name in self._term_names:
      term = self._terms[name]
      term.process_actions(action[:, idx : idx + term.action_dim])
      idx += term.action_dim

  def apply_action(self) -> None:
    for name in self._term_names:
      self._terms[name].apply_actions()

  def reset(self, env_mask=None) -> dict:
    ns = self._env.ns(self.NS)
    if env_mask is None:
      ns["action"] = torch.zeros_like(ns["action"])
      ns["prev_action"] = torch.zeros_like(ns["prev_action"])
    else:
      m = env_mask[:, None]
      ns["action"] = torch.where(m, 0.0, ns["action"])
      ns["prev_action"] = torch.where(m, 0.0, ns["prev_action"])
    for name in self._term_names:
      self._terms[name].reset(env_mask)
    return {}
