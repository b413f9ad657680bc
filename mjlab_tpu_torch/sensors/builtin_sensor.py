"""Builtin sensor wrapper (port of mjlab_tpu/sensors/builtin_sensor.py).

Binds a sensor of the compiled model by name to its (adr, dim) slice of
Data.sensordata, which the engine's sensor pass fills; any type of the JAX
package's catalog (`SENSOR_TYPES`, the JAX package's `_SENSOR_TYPES` names)
binds. The scene wraps every sensor of the compiled model
(`from_existing`); the JAX package's `BuiltinSensorCfg`, which adds a
sensor to the MjSpec before compiling, has no counterpart: the port's
scenes arrive compiled.
"""

from __future__ import annotations

from mjlab_tpu_torch.entity.entity import element_name
from mjlab_tpu_torch.physics.types import mjtSensor
from mjlab_tpu_torch.sensors.sensor import Sensor, SensorCfg

_S = mjtSensor
SENSOR_TYPES: dict[str, int] = {
  "gyro": _S.mjSENS_GYRO,
  "velocimeter": _S.mjSENS_VELOCIMETER,
  "accelerometer": _S.mjSENS_ACCELEROMETER,
  "framepos": _S.mjSENS_FRAMEPOS,
  "framequat": _S.mjSENS_FRAMEQUAT,
  "framelinvel": _S.mjSENS_FRAMELINVEL,
  "frameangvel": _S.mjSENS_FRAMEANGVEL,
  "framexaxis": _S.mjSENS_FRAMEXAXIS,
  "frameyaxis": _S.mjSENS_FRAMEYAXIS,
  "framezaxis": _S.mjSENS_FRAMEZAXIS,
  "jointpos": _S.mjSENS_JOINTPOS,
  "jointvel": _S.mjSENS_JOINTVEL,
  "subtreecom": _S.mjSENS_SUBTREECOM,
  "subtreelinvel": _S.mjSENS_SUBTREELINVEL,
  "subtreeangmom": _S.mjSENS_SUBTREEANGMOM,
  "actuatorpos": _S.mjSENS_ACTUATORPOS,
  "actuatorvel": _S.mjSENS_ACTUATORVEL,
  "actuatorfrc": _S.mjSENS_ACTUATORFRC,
  "magnetometer": _S.mjSENS_MAGNETOMETER,
  "clock": _S.mjSENS_CLOCK,
  "tendonpos": _S.mjSENS_TENDONPOS,
  "tendonvel": _S.mjSENS_TENDONVEL,
  "jointlimitpos": _S.mjSENS_JOINTLIMITPOS,
  "jointlimitvel": _S.mjSENS_JOINTLIMITVEL,
  "jointlimitfrc": _S.mjSENS_JOINTLIMITFRC,
  "jointactuatorfrc": _S.mjSENS_JOINTACTFRC,
  "framelinacc": _S.mjSENS_FRAMELINACC,
  "frameangacc": _S.mjSENS_FRAMEANGACC,
  "e_potential": _S.mjSENS_E_POTENTIAL,
  "e_kinetic": _S.mjSENS_E_KINETIC,
  "force": _S.mjSENS_FORCE,
  "torque": _S.mjSENS_TORQUE,
  "touch": _S.mjSENS_TOUCH,
  "rangefinder": _S.mjSENS_RANGEFINDER,
  "tendonactuatorfrc": _S.mjSENS_TENDONACTFRC,
}
_TYPE_NAMES = {v: k for k, v in SENSOR_TYPES.items()}


class BuiltinSensor(Sensor):
  def __init__(self, cfg: SensorCfg):
    self.cfg = cfg
    self._adr = None
    self._dim = None
    self.sensor_type = None

  @classmethod
  def from_existing(cls, name: str) -> "BuiltinSensor":
    return cls(SensorCfg(name=name))

  def initialize(self, model, ctx) -> None:
    super().initialize(model, ctx)
    names = [element_name(model, model.name_sensoradr, i) for i in range(model.nsensor)]
    if self.cfg.name not in names:
      raise ValueError(f"Sensor '{self.cfg.name}' not found in compiled model.")
    sid = names.index(self.cfg.name)
    self.sensor_type = _TYPE_NAMES[int(model.sensor_type[sid])]  # put_model refuses others
    self._adr = int(model.sensor_adr[sid])
    self._dim = int(model.sensor_dim[sid])

  @property
  def data(self):
    return self._ctx.data.sensordata[:, self._adr : self._adr + self._dim]
