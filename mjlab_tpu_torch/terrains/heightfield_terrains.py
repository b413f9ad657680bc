"""Heightfield sub-terrains: pyramid slope, random uniform noise, waves
(port of mjlab_tpu/terrains/heightfield_terrains.py, line for line).

Pure height-raster producers (meters) on a 0.1 m grid, snapped to a 5 mm
quantum; the generator turns them into height field assets, and the
port's narrowphase collides them (physics/collision.py `_hfield_group`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mjlab_tpu_torch.terrains.terrain_generator import (
  HfieldDesc,
  SubTerrainCfg,
  TerrainOutput,
)


@dataclass(kw_only=True)
class _HfBase(SubTerrainCfg):
  horizontal_scale: float = 0.1
  vertical_scale: float = 0.005
  border_width: float = 0.0

  def _grid(self) -> tuple[int, int]:
    return (
      int(self.size[0] / self.horizontal_scale),
      int(self.size[1] / self.horizontal_scale),
    )

  def _with_border(self, heights: np.ndarray) -> np.ndarray:
    bp = int(self.border_width / self.horizontal_scale)
    if bp <= 0:
      return heights
    out = np.zeros_like(heights)
    out[bp:-bp, bp:-bp] = heights[bp:-bp, bp:-bp]
    return out

  def _output(self, heights: np.ndarray, origin_z: float) -> TerrainOutput:
    heights = self._with_border(heights)
    # Snap to the vertical quantum like the reference's int16 rasters.
    heights = np.rint(heights / self.vertical_scale) * self.vertical_scale
    hf = HfieldDesc(
      heights=heights,
      size_x=self.size[0],
      size_y=self.size[1],
    )
    origin = np.array([self.size[0] / 2, self.size[1] / 2, origin_z])
    return TerrainOutput(origin=origin, hfield=hf)


@dataclass(kw_only=True)
class HfPyramidSlopedTerrainCfg(_HfBase):
  """Pyramid (or inverted pyramid) slope with a flat central platform."""

  slope_range: tuple[float, float]
  platform_width: float = 1.0
  inverted: bool = False

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    lo, hi = self.slope_range
    slope = lo + difficulty * (hi - lo)
    if self.inverted:
      slope = -slope
    nx, ny = self._grid()
    cx, cy = nx / 2, ny / 2
    xs = (cx - np.abs(cx - np.arange(nx))) / cx
    ys = (cy - np.abs(cy - np.arange(ny))) / cy
    peak = slope * self.size[0] / 2
    heights = peak * xs[:, None] * ys[None, :]
    # Clamp at the platform height so the center is flat.
    half_pf = int(self.platform_width / self.horizontal_scale / 2)
    z_pf = heights[int(cx) - half_pf, int(cy) - half_pf] if half_pf < cx else 0.0
    heights = np.clip(heights, min(0.0, z_pf), max(0.0, z_pf))
    return self._output(heights, origin_z=float(z_pf))


@dataclass(kw_only=True)
class HfInvertedPyramidSlopedTerrainCfg(HfPyramidSlopedTerrainCfg):
  inverted: bool = True


@dataclass(kw_only=True)
class HfRandomUniformTerrainCfg(_HfBase):
  """Uniform random bumps, optionally generated at a coarser resolution and
  upsampled (downsampled_scale)."""

  noise_range: tuple[float, float]
  noise_step: float = 0.01
  downsampled_scale: float | None = None

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    del difficulty
    nx, ny = self._grid()
    scale = self.downsampled_scale or self.horizontal_scale
    cx = max(int(self.size[0] / scale), 2)
    cy = max(int(self.size[1] / scale), 2)
    lo, hi = self.noise_range
    steps = np.arange(lo, hi + self.noise_step, self.noise_step)
    coarse = rng.choice(steps, size=(cx, cy))
    # Bilinear upsample to the full raster.
    xi = np.linspace(0, cx - 1, nx)
    yi = np.linspace(0, cy - 1, ny)
    x0 = np.clip(xi.astype(int), 0, cx - 2)
    y0 = np.clip(yi.astype(int), 0, cy - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    h00 = coarse[x0][:, y0]
    h10 = coarse[x0 + 1][:, y0]
    h01 = coarse[x0][:, y0 + 1]
    h11 = coarse[x0 + 1][:, y0 + 1]
    heights = (
      h00 * (1 - fx) * (1 - fy)
      + h10 * fx * (1 - fy)
      + h01 * (1 - fx) * fy
      + h11 * fx * fy
    )
    spawn = (lo + hi) / 2
    return self._output(heights, origin_z=float(spawn))


@dataclass(kw_only=True)
class HfWaveTerrainCfg(_HfBase):
  """Sinusoidal waves along both axes."""

  amplitude_range: tuple[float, float]
  num_waves: float = 1.0

  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    del rng
    lo, hi = self.amplitude_range
    amp = lo + difficulty * (hi - lo)
    nx, ny = self._grid()
    x = np.arange(nx) * self.horizontal_scale
    y = np.arange(ny) * self.horizontal_scale
    kx = 2 * np.pi * self.num_waves / self.size[0]
    ky = 2 * np.pi * self.num_waves / self.size[1]
    heights = (amp / 2) * (
      np.sin(kx * x)[:, None] + np.cos(ky * y)[None, :]
    )
    return self._output(heights, origin_z=0.0)
