"""Procedural terrain grid generator (port of
mjlab_tpu/terrains/terrain_generator.py), without MjSpec.

A num_rows × num_cols grid of sub-terrain tiles, either drawn at random
(weighted by proportion) or in curriculum mode, where the column picks the
type and the difficulty grows along the rows; a border skirt around the
grid; a seeded numpy stream. The sub-terrains return plain box and height
field descriptors. The JAX package's generator writes them into an MjSpec;
this one returns them as a list of geoms in the order that generator adds
them (tiles row-major, each tile's height field before its boxes, then the
border), with the tiles' spawn origins. `scene.compose.compose_terrain`
puts them into a compiled scene.

The draws are the JAX generator's, one for one, on the same
`np.random.default_rng(seed)` stream: the difficulty jitter, the random
type, a sub-terrain's own draws and the random color scheme's. So the same
cfg gives the same terrain bit for bit.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Literal

import numpy as np

_DARK_GRAY = (0.2, 0.2, 0.2, 1.0)
_HFIELD_RGBA = (0.45, 0.45, 0.45, 1.0)


@dataclass
class BoxDesc:
  """An axis-aligned box: full-extent sizes, center position (tile frame)."""

  pos: np.ndarray  # (3,)
  size: np.ndarray  # (3,) full extents
  rgba: tuple[float, float, float, float] | None = None


@dataclass
class HfieldDesc:
  """A heightfield raster (meters) covering the full tile."""

  heights: np.ndarray  # (nx, ny) height in meters
  size_x: float
  size_y: float
  base: float = 0.5  # skirt thickness below z=0


@dataclass
class TerrainOutput:
  origin: np.ndarray  # (3,) spawn point in the tile frame
  boxes: list[BoxDesc] = field(default_factory=list)
  hfield: HfieldDesc | None = None


def height_ramp(t: float, base=(0.25, 0.45, 0.85)) -> tuple[float, ...]:
  """Simple height-indexed color ramp: dark→light as t goes 0→1."""
  t = float(np.clip(t, 0.0, 1.0))
  return tuple(np.clip(np.asarray(base) * (0.6 + 0.8 * t), 0, 1)) + (1.0,)


def ring_boxes(
  center_xy: tuple[float, float],
  outer: tuple[float, float],
  width: float,
  z: float,
  height: float,
) -> list[BoxDesc]:
  """Four boxes forming a hollow rectangular ring of strip width `width`.

  Top/bottom strips span the full outer x extent; left/right strips fill
  the remaining y extent."""
  cx, cy = center_xy
  ox, oy = outer
  out = []
  # strips along +y / -y edges
  for sy in (+1, -1):
    out.append(
      BoxDesc(
        pos=np.array([cx, cy + sy * (oy / 2 - width / 2), z]),
        size=np.array([ox, width, height]),
      )
    )
  # strips along +x / -x edges (inset so corners are not doubled)
  for sx in (+1, -1):
    out.append(
      BoxDesc(
        pos=np.array([cx + sx * (ox / 2 - width / 2), cy, z]),
        size=np.array([width, oy - 2 * width, height]),
      )
    )
  return out


def border_boxes(
  outer: tuple[float, float],
  inner: tuple[float, float],
  height: float,
  center: tuple[float, float, float],
) -> list[BoxDesc]:
  """Hollow rectangular border."""
  cx, cy, cz = center
  tx = (outer[0] - inner[0]) / 2
  ty = (outer[1] - inner[1]) / 2
  out = []
  for sy in (+1, -1):
    out.append(
      BoxDesc(
        pos=np.array([cx, cy + sy * (inner[1] / 2 + ty / 2), cz]),
        size=np.array([outer[0], ty, height]),
      )
    )
  for sx in (+1, -1):
    out.append(
      BoxDesc(
        pos=np.array([cx + sx * (inner[0] / 2 + tx / 2), cy, cz]),
        size=np.array([tx, inner[1], height]),
      )
    )
  return out


@dataclass
class SubTerrainCfg(abc.ABC):
  proportion: float = 1.0
  size: tuple[float, float] = (10.0, 10.0)  # overwritten by the generator

  @abc.abstractmethod
  def build(self, difficulty: float, rng: np.random.Generator) -> TerrainOutput:
    """Generate terrain descriptors for one tile at the given difficulty."""


@dataclass(kw_only=True)
class TerrainGeneratorCfg:
  """The JAX package's cfg without `add_lights`: the port reads no light."""

  seed: int | None = None
  curriculum: bool = False
  size: tuple[float, float]
  border_width: float = 0.0
  border_height: float = 1.0
  num_rows: int = 1
  num_cols: int = 1
  color_scheme: Literal["height", "random", "none"] = "height"
  sub_terrains: dict[str, SubTerrainCfg] = field(default_factory=dict)
  difficulty_range: tuple[float, float] = (0.0, 1.0)


@dataclass
class HfieldAsset:
  """A height field asset as the JAX generator hands it to MuJoCo: the
  raster normalised to [0, 1] over the elevation `size[2]`, (nrow, ncol)
  with the columns along x."""

  name: str
  size: np.ndarray  # (4,): half x, half y, elevation, base
  nrow: int
  ncol: int
  data: np.ndarray  # (nrow * ncol,) float64 in [0, 1]


@dataclass
class TerrainGeom:
  """One geom of the generated terrain, in the terrain body's frame."""

  type: Literal["box", "hfield"]
  pos: np.ndarray  # (3,)
  rgba: tuple[float, float, float, float]
  size: np.ndarray | None = None  # a box's half extents
  hfield: HfieldAsset | None = None


@dataclass
class GeneratedTerrain:
  geoms: list[TerrainGeom]
  terrain_origins: np.ndarray  # (num_rows, num_cols, 3)


class TerrainGenerator:
  """Generates the terrain grid's geoms and records the tiles' spawn
  origins."""

  def __init__(self, cfg: TerrainGeneratorCfg) -> None:
    if not cfg.sub_terrains:
      raise ValueError("At least one sub_terrain must be specified.")
    self.cfg = cfg
    for sub in cfg.sub_terrains.values():
      sub.size = cfg.size
    seed = cfg.seed if cfg.seed is not None else 0
    self.rng = np.random.default_rng(seed)
    self.terrain_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

  def generate(self) -> GeneratedTerrain:
    """The geoms in the JAX `build`'s order, and the tiles' origins."""
    subs = list(self.cfg.sub_terrains.values())
    proportions = np.array([s.proportion for s in subs], dtype=float)
    proportions /= proportions.sum()

    geoms: list[TerrainGeom] = []
    for row in range(self.cfg.num_rows):
      for col in range(self.cfg.num_cols):
        sub, difficulty = self._pick(subs, proportions, row, col)
        tile_corner = self._tile_corner(row, col)
        output = sub.build(difficulty, self.rng)
        if output.hfield is not None:
          geoms.append(self._hfield_geom(output.hfield, tile_corner, row, col))
        for box in output.boxes:
          geoms.append(TerrainGeom(
            type="box", pos=np.asarray(box.pos) + tile_corner,
            rgba=self._resolve_color(box), size=box.size / 2.0,
          ))
        self.terrain_origins[row, col] = output.origin + tile_corner

    geoms += self._border_geoms()
    return GeneratedTerrain(geoms=geoms, terrain_origins=self.terrain_origins.copy())

  # -- internals -------------------------------------------------------------

  def _pick(self, subs, proportions, row: int, col: int):
    lo, hi = self.cfg.difficulty_range
    if self.cfg.curriculum:
      # Column selects type by cumulative proportion; difficulty grows along
      # rows with uniform jitter.
      idx = int(np.min(np.where(col / self.cfg.num_cols + 0.001
                                < np.cumsum(proportions))[0]))
      difficulty = (row + self.rng.uniform()) / self.cfg.num_rows
      difficulty = lo + (hi - lo) * difficulty
    else:
      idx = int(self.rng.choice(len(subs), p=proportions))
      difficulty = self.rng.uniform(lo, hi)
    return subs[idx], difficulty

  def _tile_corner(self, row: int, col: int) -> np.ndarray:
    sx, sy = self.cfg.size
    return np.array(
      [
        row * sx - self.cfg.num_rows * sx * 0.5,
        col * sy - self.cfg.num_cols * sy * 0.5,
        0.0,
      ]
    )

  def _hfield_geom(self, hf: HfieldDesc, tile_corner, row: int, col: int) -> TerrainGeom:
    """One tile's height field: normalised over its elevation, the geom at
    the tile's center with z chosen so raster heights are world heights."""
    h = hf.heights
    h_min, h_max = float(h.min()), float(h.max())
    elevation = max(h_max - h_min, 1e-6)
    normalized = (h - h_min) / elevation
    asset = HfieldAsset(
      name=f"hfield_{row}_{col}",
      size=np.array([hf.size_x / 2, hf.size_y / 2, elevation, hf.base]),
      nrow=h.shape[1],
      ncol=h.shape[0],
      data=normalized.T.reshape(-1),
    )
    center = tile_corner + np.array([hf.size_x / 2, hf.size_y / 2, h_min])
    return TerrainGeom(type="hfield", pos=center, rgba=_HFIELD_RGBA, hfield=asset)

  def _resolve_color(self, box: BoxDesc):
    if self.cfg.color_scheme == "height" and box.rgba is not None:
      return box.rgba
    if self.cfg.color_scheme == "random":
      return tuple(self.rng.uniform(0.3, 0.8, 3)) + (1.0,)
    return (0.5, 0.5, 0.5, 1.0)

  def _border_geoms(self) -> list[TerrainGeom]:
    if self.cfg.border_width <= 0:
      return []
    inner = (
      self.cfg.num_rows * self.cfg.size[0],
      self.cfg.num_cols * self.cfg.size[1],
    )
    outer = (inner[0] + 2 * self.cfg.border_width,
             inner[1] + 2 * self.cfg.border_width)
    return [
      TerrainGeom(type="box", pos=np.asarray(box.pos, dtype=float), rgba=_DARK_GRAY,
                  size=box.size / 2.0)
      for box in border_boxes(outer, inner, abs(self.cfg.border_height),
                              (0, 0, -self.cfg.border_height / 2))
    ]
