"""Observation noise (port of mjlab_tpu/utils/noise.py): constant, uniform
and Gaussian noise with add/scale/abs operations, and the noise models: the
stateless `NoiseModel` (its `noise_cfg` per step) and
`NoiseModelWithAdditiveBias`, which adds a per-env bias drawn again at each
reset of that env. A model's state (the bias) lives in the env's
"observation" namespace. Every draw comes from the env's torch.Generator."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

from mjlab_tpu_torch.distributed.sharding import env_rows


@dataclass
class NoiseCfg:
  operation: Literal["add", "scale", "abs"] = "add"

  def apply(self, generator: torch.Generator, data: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError

  def _combine(self, data, noise):
    if self.operation == "add":
      return data + noise
    if self.operation == "scale":
      return data * noise
    if self.operation == "abs":
      return torch.broadcast_to(noise, data.shape)
    raise ValueError(f"Unknown operation {self.operation}")


@dataclass
class ConstantNoiseCfg(NoiseCfg):
  bias: float = 0.0

  def apply(self, generator, data):
    del generator
    return self._combine(data, torch.full_like(data, self.bias))


@dataclass
class UniformNoiseCfg(NoiseCfg):
  n_min: float = -1.0
  n_max: float = 1.0

  def apply(self, generator, data):
    u = env_rows(torch.rand, data.shape, generator=generator, dtype=data.dtype,
                 device=data.device)
    return self._combine(data, self.n_min + u * (self.n_max - self.n_min))


@dataclass
class GaussianNoiseCfg(NoiseCfg):
  mean: float = 0.0
  std: float = 1.0

  def apply(self, generator, data):
    n = env_rows(torch.randn, data.shape, generator=generator, dtype=data.dtype,
                 device=data.device)
    return self._combine(data, self.mean + self.std * n)


@dataclass
class NoiseModelCfg:
  class_type: type | None = None
  noise_cfg: NoiseCfg | None = None


class NoiseModel:
  """The stateless noise model: `noise_cfg` applied per step."""

  def __init__(self, cfg: NoiseModelCfg, num_envs: int):
    self.cfg = cfg
    self.num_envs = num_envs

  def init_state(self, example: torch.Tensor) -> dict:
    """Per-env state shaped like `example`, a (B, ...) term output."""
    del example
    return {}

  def apply(self, state: dict, generator: torch.Generator, data: torch.Tensor) -> torch.Tensor:
    if self.cfg.noise_cfg is None:
      return data
    return self.cfg.noise_cfg.apply(generator, data)

  def reset(self, state: dict, generator: torch.Generator, env_mask) -> dict:
    return state


@dataclass
class NoiseModelWithAdditiveBiasCfg(NoiseModelCfg):
  bias_noise_cfg: NoiseCfg | None = None

  def __post_init__(self):
    self.class_type = NoiseModelWithAdditiveBias


class NoiseModelWithAdditiveBias(NoiseModel):
  """Per-step noise plus a per-env additive bias, constant over an episode
  and drawn again (from `bias_noise_cfg` applied to zeros) at each reset."""

  def init_state(self, example: torch.Tensor) -> dict:
    return {"bias": torch.zeros_like(example)}

  def apply(self, state, generator, data):
    return super().apply(state, generator, data) + state["bias"]

  def reset(self, state, generator, env_mask) -> dict:
    cfg: NoiseModelWithAdditiveBiasCfg = self.cfg  # type: ignore[assignment]
    bias = state["bias"]
    if cfg.bias_noise_cfg is not None:
      new_bias = cfg.bias_noise_cfg.apply(generator, torch.zeros_like(bias))
      if env_mask is None:
        bias = new_bias
      else:
        m = env_mask.reshape(env_mask.shape + (1,) * (bias.dim() - 1))
        bias = torch.where(m, new_bias, bias)
    return {"bias": bias}
