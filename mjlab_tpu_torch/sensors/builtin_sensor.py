"""Builtin sensor wrapper (port of mjlab_tpu/sensors/builtin_sensor.py).

Binds a sensor of the compiled model by name to its (adr, dim) slice of
Data.sensordata, which the engine's sensor pass fills. The scene wraps
every sensor of the compiled model (`from_existing`); the JAX package's
`BuiltinSensorCfg`, which adds a sensor to the MjSpec before compiling, has
no counterpart: the port's scenes arrive compiled.
"""

from __future__ import annotations

from mjlab_tpu_torch.entity.entity import element_name
from mjlab_tpu_torch.sensors.sensor import Sensor, SensorCfg


class BuiltinSensor(Sensor):
  def __init__(self, cfg: SensorCfg):
    self.cfg = cfg
    self._adr = None
    self._dim = None

  @classmethod
  def from_existing(cls, name: str) -> "BuiltinSensor":
    return cls(SensorCfg(name=name))

  def initialize(self, model, ctx) -> None:
    super().initialize(model, ctx)
    names = [element_name(model, model.name_sensoradr, i) for i in range(model.nsensor)]
    if self.cfg.name not in names:
      raise ValueError(f"Sensor '{self.cfg.name}' not found in compiled model.")
    sid = names.index(self.cfg.name)
    self._adr = int(model.sensor_adr[sid])
    self._dim = int(model.sensor_dim[sid])

  @property
  def data(self):
    return self._ctx.data.sensordata[:, self._adr : self._adr + self._dim]
