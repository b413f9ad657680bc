from mjlab_tpu_torch.terrains.terrain_importer import (
  TerrainGeneratorCfg,
  TerrainImporter,
  TerrainImporterCfg,
  rough_terrains_cfg,
)

__all__ = [
  "TerrainGeneratorCfg",
  "TerrainImporter",
  "TerrainImporterCfg",
  "rough_terrains_cfg",
]
