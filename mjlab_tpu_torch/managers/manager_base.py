"""Manager base classes (port of mjlab_tpu/managers/manager_base.py).

ManagerBase resolves term configs at construction (SceneEntityCfg
resolution, class-term instantiation). Per-step state lives in the env's
namespace dicts (`env.ns(manager_name)`), one tensor per leaf, named as in
the JAX package's EnvState.
"""

from __future__ import annotations

import inspect
from typing import TYPE_CHECKING, Any

from mjlab_tpu_torch.managers.manager_term_config import ManagerTermBaseCfg
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

if TYPE_CHECKING:
  from mjlab_tpu_torch.envs.manager_based_env import ManagerBasedEnv


class ManagerTermBase:
  """Base for class-based terms (stateful terms implement init_state/reset)."""

  NS: str | None = None  # manager namespace; set by the owning manager

  def __init__(self, cfg: Any, env: "ManagerBasedEnv"):
    self.cfg = cfg
    self._env = env
    self._term_name: str | None = None

  @property
  def state(self) -> dict:
    """Per-term state (allocated from init_state by the manager)."""
    return self._env.ns(self.NS)["term_state"][self._term_name]

  @property
  def num_envs(self) -> int:
    return self._env.num_envs

  def init_state(self) -> dict:
    return {}

  def reset(self, env_mask=None) -> None:
    pass

  def __call__(self, env, **kwargs):
    raise NotImplementedError


class ManagerBase:
  def __init__(self, env: "ManagerBasedEnv"):
    self._env = env
    self._prepare_terms()

  @property
  def num_envs(self) -> int:
    return self._env.num_envs

  def _prepare_terms(self) -> None:
    raise NotImplementedError

  def reset(self, env_mask=None) -> dict:
    return {}

  def _resolve_common_term_cfg(self, name: str, cfg: ManagerTermBaseCfg) -> None:
    """Resolve SceneEntityCfg params and instantiate class-based terms."""
    if not isinstance(cfg, ManagerTermBaseCfg):
      return
    for value in cfg.params.values():
      if isinstance(value, SceneEntityCfg):
        value.resolve(self._env.scene)
    if inspect.isclass(cfg.func):
      cfg.func = cfg.func(cfg, self._env)
