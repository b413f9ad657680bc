"""Observation manager (port of mjlab_tpu/managers/observation_manager.py).

Per-term pipeline: compute → noise → clip → scale → concat. The JAX
package's sensor delay, observation history and stateful noise models are
not ported (they need utils/buffers.py); a term that asks for them raises
`NotImplementedError`. The "observation" namespace keeps the JAX package's
(empty) delay/history/noise dicts.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase
from mjlab_tpu_torch.managers.manager_term_config import (
  ObservationGroupCfg,
  ObservationTermCfg,
)
from mjlab_tpu_torch.utils.noise import NoiseCfg, NoiseModelCfg


class ObservationManager(ManagerBase):
  NS = "observation"

  def __init__(self, cfg: dict[str, ObservationGroupCfg], env):
    self.cfg = cfg
    super().__init__(env)
    self._infer_dims()
    env.ns(self.NS).update(self.init_state())

  def _prepare_terms(self) -> None:
    self._group_term_names: dict[str, list[str]] = {}
    self._group_term_cfgs: dict[str, list[ObservationTermCfg]] = {}
    self._group_concatenate: dict[str, bool] = {}
    self._scales: dict[tuple[str, str], torch.Tensor] = {}
    for group_name, group_cfg in self.cfg.items():
      if group_cfg is None:
        continue
      if group_cfg.history_length:
        raise NotImplementedError(
          f"observation history (group '{group_name}') is not supported by "
          "mjlab_tpu_torch"
        )
      self._group_term_names[group_name] = []
      self._group_term_cfgs[group_name] = []
      self._group_concatenate[group_name] = group_cfg.concatenate_terms
      for term_name, term_cfg in group_cfg.terms.items():
        if term_cfg is None:
          continue
        where = f"{group_name}/{term_name}"
        if term_cfg.history_length > 0:
          raise NotImplementedError(
            f"observation history (term '{where}') is not supported by mjlab_tpu_torch"
          )
        if term_cfg.delay_max_lag > 0:
          raise NotImplementedError(
            f"observation delay (term '{where}') is not supported by mjlab_tpu_torch"
          )
        self._resolve_common_term_cfg(where, term_cfg)
        if not group_cfg.enable_corruption:
          term_cfg.noise = None
        if isinstance(term_cfg.noise, NoiseModelCfg):
          raise NotImplementedError(
            f"noise models (term '{where}') are not supported by mjlab_tpu_torch"
          )
        if isinstance(term_cfg.scale, tuple):
          self._scales[(group_name, term_name)] = torch.as_tensor(
            term_cfg.scale, dtype=self._env.dtype, device=self._env.device
          )
        self._group_term_names[group_name].append(term_name)
        self._group_term_cfgs[group_name].append(term_cfg)

  def _infer_dims(self) -> None:
    """Dry-run terms on the current state to infer shapes."""
    self._group_obs_term_dim: dict[str, list[tuple[int, ...]]] = {}
    self._group_obs_dim: dict[str, tuple[int, ...] | list] = {}
    for group_name in self._group_term_names:
      dims = [
        tuple(cfg.func(self._env, **cfg.params).shape[1:])
        for cfg in self._group_term_cfgs[group_name]
      ]
      self._group_obs_term_dim[group_name] = dims
      if self._group_concatenate[group_name]:
        self._group_obs_dim[group_name] = (sum(d[-1] for d in dims),)
      else:
        self._group_obs_dim[group_name] = dims

  @property
  def active_terms(self) -> dict[str, list[str]]:
    return self._group_term_names

  @property
  def group_obs_dim(self):
    return self._group_obs_dim

  def init_state(self) -> dict:
    return {"delay": {}, "history": {}, "noise": {}}

  def compute(self) -> dict:
    return {g: self.compute_group(g) for g in self._group_term_names}

  def compute_group(self, group_name: str):
    group_obs = {}
    for term_name, term_cfg in zip(
      self._group_term_names[group_name], self._group_term_cfgs[group_name]
    ):
      obs = term_cfg.func(self._env, **term_cfg.params)
      if isinstance(term_cfg.noise, NoiseCfg):
        obs = term_cfg.noise.apply(self._env.generator, obs)
      if term_cfg.clip is not None:
        obs = torch.clamp(obs, term_cfg.clip[0], term_cfg.clip[1])
      if term_cfg.scale is not None:
        obs = obs * self._scales.get((group_name, term_name), term_cfg.scale)
      group_obs[term_name] = obs
    if self._group_concatenate[group_name]:
      return torch.cat(list(group_obs.values()), dim=-1)
    return group_obs

  def reset(self, env_mask=None) -> dict:
    return {}
