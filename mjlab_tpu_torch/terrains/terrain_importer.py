"""Terrain importer, its runtime half (port of
mjlab_tpu/terrains/terrain_importer.py): env origins and the curriculum's
terrain levels.

The JAX package generates the terrain into the scene's MjSpec
(terrain_generator.py and the sub-terrain modules). The port composes no
MjSpec: the generated terrain arrives compiled in the scene npz, with the
tiles' spawn origins beside it (`terrain_origins`, (num_rows, num_cols,
3)). Of the generator's configuration the port keeps only the fields it
reads; the scene checks the grid against the npz's.

As in the JAX package, `env_origins` stays where `initialize` put it: the
curriculum moves an env's level but no reset reads the level's origin
(ROADMAP Queue C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch


@dataclass(kw_only=True)
class TerrainGeneratorCfg:
  """The fields of the JAX package's TerrainGeneratorCfg the port reads."""

  size: tuple[float, float] = (8.0, 8.0)
  num_rows: int = 1
  num_cols: int = 1
  curriculum: bool = False


def rough_terrains_cfg() -> TerrainGeneratorCfg:
  """The grid of the JAX package's ROUGH_TERRAINS_CFG (terrains/config.py):
  10 rows of difficulty by 20 columns of 8 m tiles."""
  return TerrainGeneratorCfg(size=(8.0, 8.0), num_rows=10, num_cols=20)


@dataclass
class TerrainImporterCfg:
  terrain_type: Literal["plane", "generator"] = "plane"
  terrain_generator: TerrainGeneratorCfg | None = None
  max_init_terrain_level: int | None = None


class TerrainImporter:
  """Env origins (a grid for the plane; the tiles' origins at each env's
  initial level and type for a generator) and the terrain state."""

  def __init__(self, cfg: TerrainImporterCfg, num_envs: int, env_spacing: float,
               terrain_origins: np.ndarray | None) -> None:
    self.cfg = cfg
    self.num_envs = num_envs
    self.env_spacing = env_spacing
    self.terrain_origins = terrain_origins
    self.env_origins: torch.Tensor | None = None

  def initialize(self, ctx) -> None:
    self._ctx = ctx
    n = self.num_envs
    if self.terrain_origins is not None:
      rows, cols = self.terrain_origins.shape[:2]
      max_level = self.cfg.max_init_terrain_level
      max_level = rows if max_level is None else min(max_level + 1, rows)
      rng = np.random.default_rng(0)
      self._init_levels = rng.integers(0, max_level, n)
      self._init_types = np.arange(n) % cols
      origins = self.terrain_origins[self._init_levels, self._init_types]
    else:
      side = int(np.ceil(np.sqrt(n)))
      ii, jj = np.unravel_index(np.arange(n), (side, side))
      origins = np.zeros((n, 3))
      origins[:, 0] = (ii - (side - 1) / 2) * self.env_spacing
      origins[:, 1] = (jj - (side - 1) / 2) * self.env_spacing
    self.env_origins = torch.as_tensor(origins, dtype=ctx.dtype, device=ctx.device)

  def init_state(self) -> dict:
    if self.terrain_origins is None:
      return {}
    dev = self._ctx.device
    return {
      "terrain_levels": torch.as_tensor(self._init_levels, dtype=torch.int32, device=dev),
      "terrain_types": torch.as_tensor(self._init_types, dtype=torch.int32, device=dev),
    }

  @property
  def state(self) -> dict:
    return self._ctx.ns("scene")["terrain"]

  def update_env_origins(self, env_mask, move_up, move_down) -> None:
    """Promote or demote the masked envs by one difficulty row, within the
    grid (reference terrain_importer.py:186-201). Only the levels move."""
    if self.terrain_origins is None:
      return
    st = self.state
    levels = st["terrain_levels"]
    delta = move_up.to(torch.int32) - move_down.to(torch.int32)
    new_levels = torch.clamp(levels + delta, 0, self.max_terrain_level - 1)
    st["terrain_levels"] = torch.where(env_mask, new_levels, levels)

  @property
  def terrain_levels(self) -> torch.Tensor:
    return self.state["terrain_levels"]

  @property
  def max_terrain_level(self) -> int:
    return 1 if self.terrain_origins is None else self.terrain_origins.shape[0]
