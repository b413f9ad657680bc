"""Box-geom sub-terrains: flat, pyramid stairs (regular/inverted), random
grid (port of mjlab_tpu/terrains/primitive_terrains.py, line for line).

Pure box-descriptor producers (see terrain_generator.BoxDesc). Spawn
origins: the tile center at the top (stairs) or bottom (inverted) platform.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mjlab_tpu_torch.terrains.terrain_generator import (
  BoxDesc,
  SubTerrainCfg,
  TerrainOutput,
  border_boxes,
  height_ramp,
  ring_boxes,
)

_BLUE = (0.20, 0.45, 0.95)
_RED = (0.90, 0.30, 0.30)


@dataclass(kw_only=True)
class BoxFlatTerrainCfg(SubTerrainCfg):
  """A flat slab tile (finite box, not a plane, so tiles can abut)."""

  thickness: float = 1.0

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    del difficulty, rng
    sx, sy = self.size
    slab = BoxDesc(
      pos=np.array([sx / 2, sy / 2, -self.thickness / 2]),
      size=np.array([sx, sy, self.thickness]),
      rgba=(0.5, 0.5, 0.5, 1.0),
    )
    return TerrainOutput(origin=np.array([sx / 2, sy / 2, 0.0]), boxes=[slab])


@dataclass(kw_only=True)
class BoxPyramidStairsTerrainCfg(SubTerrainCfg):
  """Concentric rising stair rings toward a central platform."""

  step_height_range: tuple[float, float]
  step_width: float
  platform_width: float = 1.0
  border_width: float = 0.0
  holes: bool = False
  inverted: bool = False

  def _num_steps(self) -> int:
    usable = min(self.size) - 2 * self.border_width - self.platform_width
    return int(usable // (2 * self.step_width) + 1)

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    del rng
    lo, hi = self.step_height_range
    step_h = lo + difficulty * (hi - lo)
    n = self._num_steps()
    sign = -1.0 if self.inverted else 1.0
    base = tuple(_RED) if self.inverted else tuple(_BLUE)

    cx, cy = self.size[0] / 2, self.size[1] / 2
    inner = (self.size[0] - 2 * self.border_width,
             self.size[1] - 2 * self.border_width)
    boxes: list[BoxDesc] = []

    if self.border_width > 0 and not self.holes:
      boxes += border_boxes(self.size, inner, step_h,
                            (cx, cy, -step_h / 2 * (1 if not self.inverted else 1)))
      for b in boxes:
        b.rgba = height_ramp(0.0, base)

    total_h = (n + 1) * step_h
    for k in range(n):
      outer = (inner[0] - 2 * k * self.step_width,
               inner[1] - 2 * k * self.step_width)
      if self.inverted:
        # Rings descend: each ring's top surface sits k+1 steps below zero.
        height = total_h - (k + 1) * step_h
        z = -total_h / 2 - (k + 1) * step_h / 2
      else:
        # Rings rise: box tops at (k+1)·step_h, extended below ground.
        height = (k + 2) * step_h
        z = k * step_h / 2
      ring = ring_boxes((cx, cy), outer, self.step_width, z, height)
      rgba = height_ramp(k / max(n - 1, 1), base)
      for b in ring:
        b.rgba = rgba
      boxes += ring

    # Central platform.
    plat_xy = (inner[0] - 2 * n * self.step_width,
               inner[1] - 2 * n * self.step_width)
    if self.inverted:
      plat = BoxDesc(
        pos=np.array([cx, cy, -total_h - step_h / 2]),
        size=np.array([plat_xy[0], plat_xy[1], step_h]),
        rgba=height_ramp(1.0, base),
      )
      origin_z = -(n + 1) * step_h
    else:
      plat = BoxDesc(
        pos=np.array([cx, cy, n * step_h / 2]),
        size=np.array([plat_xy[0], plat_xy[1], (n + 2) * step_h]),
        rgba=height_ramp(1.0, base),
      )
      origin_z = (n + 1) * step_h
    boxes.append(plat)
    return TerrainOutput(
      origin=np.array([cx, cy, sign * abs(origin_z)]), boxes=boxes
    )


@dataclass(kw_only=True)
class BoxInvertedPyramidStairsTerrainCfg(BoxPyramidStairsTerrainCfg):
  inverted: bool = True


@dataclass(kw_only=True)
class BoxRandomGridTerrainCfg(SubTerrainCfg):
  """Grid of cells with random heights; flat central platform.

  Cells are emitted directly, one box each, as in the JAX package: the
  terrain broadphase prunes static-static pairs, so the extra geoms only
  cost model size.
  """

  grid_width: float
  grid_height_range: tuple[float, float]
  platform_width: float = 1.0
  holes: bool = False

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    if self.size[0] != self.size[1]:
      raise ValueError(f"Random-grid terrain must be square, got {self.size}.")
    lo, hi = self.grid_height_range
    h_max = lo + difficulty * (hi - lo)
    n = int(self.size[0] / self.grid_width)
    depth = 1.0

    cx, cy = self.size[0] / 2, self.size[1] / 2
    boxes: list[BoxDesc] = []
    for i in range(n):
      for j in range(n):
        x = (i + 0.5) * self.grid_width
        y = (j + 0.5) * self.grid_width
        if (
          abs(x - cx) < self.platform_width / 2
          and abs(y - cy) < self.platform_width / 2
        ):
          continue
        h = rng.uniform(-h_max, h_max)
        boxes.append(
          BoxDesc(
            pos=np.array([x, y, h / 2 - depth / 2]),
            size=np.array([self.grid_width, self.grid_width, depth + h]),
            rgba=height_ramp((h + h_max) / max(2 * h_max, 1e-6)),
          )
        )
    # Platform.
    boxes.append(
      BoxDesc(
        pos=np.array([cx, cy, -depth / 2]),
        size=np.array([self.platform_width, self.platform_width, depth]),
        rgba=(0.5, 0.5, 0.5, 1.0),
      )
    )
    return TerrainOutput(origin=np.array([cx, cy, 0.0]), boxes=boxes)
