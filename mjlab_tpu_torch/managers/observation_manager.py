"""Observation manager (port of mjlab_tpu/managers/observation_manager.py).

Per-term pipeline, in the JAX package's order: compute → noise (a noise cfg
or a noise model) → clip → scale → delay → history → concat. The delay,
history and noise-model state lives in the env's "observation" namespace
under "delay", "history" and "noise", keyed "<group>/<term>", with the JAX
package's names (utils/buffers.py, utils/noise.py). A group's
`history_length`, when set, overrides its terms'.
"""

from __future__ import annotations

import math

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase
from mjlab_tpu_torch.managers.manager_term_config import (
  ObservationGroupCfg,
  ObservationTermCfg,
)
from mjlab_tpu_torch.utils.buffers import CircularBuffer, DelayBuffer
from mjlab_tpu_torch.utils.noise import NoiseCfg, NoiseModel, NoiseModelCfg


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
    self._delay_buffers: dict[tuple[str, str], DelayBuffer] = {}
    self._history_buffers: dict[tuple[str, str], CircularBuffer] = {}
    self._noise_models: dict[tuple[str, str], NoiseModel] = {}
    for group_name, group_cfg in self.cfg.items():
      if group_cfg is None:
        continue
      self._group_term_names[group_name] = []
      self._group_term_cfgs[group_name] = []
      self._group_concatenate[group_name] = group_cfg.concatenate_terms
      for term_name, term_cfg in group_cfg.terms.items():
        if term_cfg is None:
          continue
        self._resolve_common_term_cfg(f"{group_name}/{term_name}", term_cfg)
        if not group_cfg.enable_corruption:
          term_cfg.noise = None
        if group_cfg.history_length is not None:
          term_cfg.history_length = group_cfg.history_length
          term_cfg.flatten_history_dim = group_cfg.flatten_history_dim
        key = (group_name, term_name)
        if isinstance(term_cfg.scale, tuple):
          self._scales[key] = torch.as_tensor(
            term_cfg.scale, dtype=self._env.dtype, device=self._env.device
          )
        if term_cfg.delay_max_lag > 0:
          self._delay_buffers[key] = DelayBuffer(
            min_lag=term_cfg.delay_min_lag,
            max_lag=term_cfg.delay_max_lag,
            batch_size=self.num_envs,
            per_env=term_cfg.delay_per_env,
            hold_prob=term_cfg.delay_hold_prob,
            update_period=term_cfg.delay_update_period,
            per_env_phase=term_cfg.delay_per_env_phase,
          )
        if term_cfg.history_length > 0:
          self._history_buffers[key] = CircularBuffer(
            max_len=term_cfg.history_length, batch_size=self.num_envs
          )
        if isinstance(term_cfg.noise, NoiseModelCfg):
          cls = term_cfg.noise.class_type or NoiseModel
          self._noise_models[key] = cls(term_cfg.noise, num_envs=self.num_envs)
        self._group_term_names[group_name].append(term_name)
        self._group_term_cfgs[group_name].append(term_cfg)

  def _infer_dims(self) -> None:
    """Dry-run terms on the current state to infer shapes."""
    self._group_obs_term_dim: dict[str, list[tuple[int, ...]]] = {}
    self._group_obs_dim: dict[str, tuple[int, ...] | list] = {}
    for group_name in self._group_term_names:
      dims = []
      for cfg in self._group_term_cfgs[group_name]:
        shape = tuple(cfg.func(self._env, **cfg.params).shape[1:])
        if cfg.history_length > 0:
          if cfg.flatten_history_dim:
            shape = (math.prod(shape) * cfg.history_length,)
          else:
            shape = (cfg.history_length,) + shape
        dims.append(shape)
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

  # -- state ----------------------------------------------------------------------

  def _term_cfg(self, group: str, term: str) -> ObservationTermCfg:
    return self._group_term_cfgs[group][self._group_term_names[group].index(term)]

  def _example(self, group: str, term: str) -> torch.Tensor:
    cfg = self._term_cfg(group, term)
    return cfg.func(self._env, **cfg.params)

  def init_state(self) -> dict:
    gen = self._env.generator
    state: dict = {"delay": {}, "history": {}, "noise": {}}
    for (g, t), db in self._delay_buffers.items():
      state["delay"][f"{g}/{t}"] = db.init_state(self._example(g, t), gen)
    for (g, t), hb in self._history_buffers.items():
      state["history"][f"{g}/{t}"] = hb.init_state(self._example(g, t))
    for (g, t), nm in self._noise_models.items():
      state["noise"][f"{g}/{t}"] = nm.init_state(self._example(g, t))
    return state

  # -- compute ----------------------------------------------------------------------

  def compute(self, update_history: bool = False) -> dict:
    return {g: self.compute_group(g, update_history) for g in self._group_term_names}

  def compute_group(self, group_name: str, update_history: bool = False):
    """The group's observations. Every call appends to the delay buffers;
    the history buffers take the result only with `update_history` (the
    env's step and reset)."""
    ns = self._env.ns(self.NS)
    gen = self._env.generator
    group_obs = {}
    for term_name, term_cfg in zip(
      self._group_term_names[group_name], self._group_term_cfgs[group_name]
    ):
      key = (group_name, term_name)
      skey = f"{group_name}/{term_name}"
      obs = term_cfg.func(self._env, **term_cfg.params)
      if isinstance(term_cfg.noise, NoiseCfg):
        obs = term_cfg.noise.apply(gen, obs)
      elif isinstance(term_cfg.noise, NoiseModelCfg):
        obs = self._noise_models[key].apply(ns["noise"][skey], gen, obs)
      if term_cfg.clip is not None:
        obs = torch.clamp(obs, term_cfg.clip[0], term_cfg.clip[1])
      if term_cfg.scale is not None:
        obs = obs * self._scales.get(key, term_cfg.scale)
      # As in the JAX package, the term cfg decides (a cfg that two groups
      # share carries the last group's history override).
      if term_cfg.delay_max_lag > 0:
        db = self._delay_buffers[key]
        ns["delay"][skey] = db.append(ns["delay"][skey], obs, gen)
        obs = db.compute(ns["delay"][skey])
      if term_cfg.history_length > 0:
        hb = self._history_buffers[key]
        if update_history:
          ns["history"][skey] = hb.append(ns["history"][skey], obs)
        obs = hb.buffer(ns["history"][skey])
        if term_cfg.flatten_history_dim:
          obs = obs.reshape(self.num_envs, -1)
      group_obs[term_name] = obs
    if self._group_concatenate[group_name]:
      return torch.cat(list(group_obs.values()), dim=-1)
    return group_obs

  def reset(self, env_mask=None) -> dict:
    ns = self._env.ns(self.NS)
    for (g, t), db in self._delay_buffers.items():
      ns["delay"][f"{g}/{t}"] = db.reset(ns["delay"][f"{g}/{t}"], env_mask)
    for (g, t), hb in self._history_buffers.items():
      ns["history"][f"{g}/{t}"] = hb.reset(ns["history"][f"{g}/{t}"], env_mask)
    for (g, t), nm in self._noise_models.items():
      ns["noise"][f"{g}/{t}"] = nm.reset(ns["noise"][f"{g}/{t}"], self._env.generator,
                                         env_mask)
    return {}
