"""Terrain presets (port of mjlab_tpu/terrains/config.py).

`ROUGH_TERRAINS_CFG`: 10 rows of difficulty by 20 columns of 8 m tiles,
flat slabs and pyramid stairs (regular and inverted) behind a 20 m border.
`ROUGH_TERRAINS_WITH_HF_CFG`: the same grid with 8 of its 20 columns given
to height fields (pyramid slopes, random bumps, waves).

Each name hands out a fresh copy: the generator writes its tile size into
the sub-terrain cfgs, and a task edits its own terrain, so no two users
share one object.
"""

from __future__ import annotations

import copy

from mjlab_tpu_torch.terrains.heightfield_terrains import (
  HfPyramidSlopedTerrainCfg,
  HfRandomUniformTerrainCfg,
  HfWaveTerrainCfg,
)
from mjlab_tpu_torch.terrains.primitive_terrains import (
  BoxFlatTerrainCfg,
  BoxInvertedPyramidStairsTerrainCfg,
  BoxPyramidStairsTerrainCfg,
)
from mjlab_tpu_torch.terrains.terrain_generator import TerrainGeneratorCfg

_STAIRS = dict(step_height_range=(0.0, 0.1), step_width=0.3, platform_width=3.0,
               border_width=1.0)

_PRESETS = {
  "ROUGH_TERRAINS_CFG": TerrainGeneratorCfg(
    size=(8.0, 8.0),
    border_width=20.0,
    num_rows=10,
    num_cols=20,
    sub_terrains={
      "flat": BoxFlatTerrainCfg(proportion=0.4),
      "pyramid_stairs": BoxPyramidStairsTerrainCfg(proportion=0.3, **_STAIRS),
      "pyramid_stairs_inv": BoxInvertedPyramidStairsTerrainCfg(proportion=0.3, **_STAIRS),
    },
  ),
  "ROUGH_TERRAINS_WITH_HF_CFG": TerrainGeneratorCfg(
    size=(8.0, 8.0),
    border_width=20.0,
    num_rows=10,
    num_cols=20,
    sub_terrains={
      "flat": BoxFlatTerrainCfg(proportion=0.2),
      "pyramid_stairs": BoxPyramidStairsTerrainCfg(proportion=0.2, **_STAIRS),
      "pyramid_stairs_inv": BoxInvertedPyramidStairsTerrainCfg(proportion=0.2, **_STAIRS),
      "hf_pyramid_slope": HfPyramidSlopedTerrainCfg(
        proportion=0.1,
        slope_range=(0.0, 0.4),
        platform_width=2.0,
        border_width=0.25,
      ),
      "random_rough": HfRandomUniformTerrainCfg(
        proportion=0.2,
        noise_range=(0.02, 0.10),
        noise_step=0.02,
        border_width=0.25,
      ),
      "wave": HfWaveTerrainCfg(
        proportion=0.1,
        amplitude_range=(0.0, 0.2),
        num_waves=4,
        border_width=0.25,
      ),
    },
  ),
}

__all__ = list(_PRESETS)


def __getattr__(name: str) -> TerrainGeneratorCfg:
  if name in _PRESETS:
    return copy.deepcopy(_PRESETS[name])
  raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
