"""Sensor framework (port of mjlab_tpu/sensors/sensor.py).

Lifecycle: `initialize` binds indices to the compiled model and keeps the
env's state context; `init_state`/`update`/`reset` carry the sensor's state
in the env's "scene" namespace; the `data` property reads the current
state. The JAX package's `edit_spec` (pre-compile additions) has no
counterpart: the port's scenes arrive compiled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, TypeVar

T = TypeVar("T")


@dataclass
class SensorCfg:
  name: str = ""

  def build(self) -> "Sensor":
    raise NotImplementedError


class Sensor(Generic[T]):
  cfg: SensorCfg

  def initialize(self, model, ctx) -> None:
    """Bind indices after compilation; keep a handle to the state context."""
    self._ctx = ctx

  def init_state(self) -> dict:
    return {}

  @property
  def data(self) -> T:
    raise NotImplementedError

  def update(self, dt: float) -> None:
    pass

  def reset(self, env_mask=None) -> None:
    pass
