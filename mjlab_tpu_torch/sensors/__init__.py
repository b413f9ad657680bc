from mjlab_tpu_torch.sensors.sensor import Sensor, SensorCfg
from mjlab_tpu_torch.sensors.builtin_sensor import BuiltinSensor
from mjlab_tpu_torch.sensors.contact_sensor import (
  ContactData,
  ContactMatch,
  ContactSensor,
  ContactSensorCfg,
)

__all__ = [
  "BuiltinSensor",
  "ContactData",
  "ContactMatch",
  "ContactSensor",
  "ContactSensorCfg",
  "Sensor",
  "SensorCfg",
]
