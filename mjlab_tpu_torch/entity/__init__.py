from mjlab_tpu_torch.entity.entity import (
  Entity,
  EntityArticulationInfoCfg,
  EntityCfg,
  EntityIndexing,
)
from mjlab_tpu_torch.entity.data import EntityData

__all__ = [
  "Entity",
  "EntityArticulationInfoCfg",
  "EntityCfg",
  "EntityData",
  "EntityIndexing",
]
