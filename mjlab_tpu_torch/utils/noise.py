"""Observation noise (port of mjlab_tpu/utils/noise.py): constant, uniform
and Gaussian noise with add/scale/abs operations. Every draw comes from the
env's torch.Generator. The stateful noise models (`NoiseModelCfg`) are not
ported; the observation manager refuses them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch


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
    u = torch.rand(data.shape, generator=generator, dtype=data.dtype, device=data.device)
    return self._combine(data, self.n_min + u * (self.n_max - self.n_min))


@dataclass
class GaussianNoiseCfg(NoiseCfg):
  mean: float = 0.0
  std: float = 1.0

  def apply(self, generator, data):
    n = torch.randn(data.shape, generator=generator, dtype=data.dtype, device=data.device)
    return self._combine(data, self.mean + self.std * n)


@dataclass
class NoiseModelCfg:
  """Stateful noise model (JAX package only; refused by the port)."""

  class_type: type | None = None
  noise_cfg: NoiseCfg | None = None
