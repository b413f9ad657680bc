from mjlab_tpu_torch.terrains.heightfield_terrains import (
  HfInvertedPyramidSlopedTerrainCfg,
  HfPyramidSlopedTerrainCfg,
  HfRandomUniformTerrainCfg,
  HfWaveTerrainCfg,
)
from mjlab_tpu_torch.terrains.primitive_terrains import (
  BoxFlatTerrainCfg,
  BoxInvertedPyramidStairsTerrainCfg,
  BoxPyramidStairsTerrainCfg,
  BoxRandomGridTerrainCfg,
)
from mjlab_tpu_torch.terrains.terrain_generator import (
  SubTerrainCfg,
  TerrainGenerator,
  TerrainGeneratorCfg,
)
from mjlab_tpu_torch.terrains.terrain_importer import TerrainImporter, TerrainImporterCfg

__all__ = [
  "BoxFlatTerrainCfg",
  "HfInvertedPyramidSlopedTerrainCfg",
  "HfPyramidSlopedTerrainCfg",
  "HfRandomUniformTerrainCfg",
  "HfWaveTerrainCfg",
  "BoxInvertedPyramidStairsTerrainCfg",
  "BoxPyramidStairsTerrainCfg",
  "BoxRandomGridTerrainCfg",
  "SubTerrainCfg",
  "TerrainGenerator",
  "TerrainGeneratorCfg",
  "TerrainImporter",
  "TerrainImporterCfg",
]
