"""The PyTorch port's terrain generator against the JAX package's, exactly:
each of the eight sub-terrains at three difficulties and two seeds gives
the same boxes (position, size, color), height raster and origin; the
generator, in curriculum and random mode under the height and the random
color scheme, gives the same geoms in the same order (boxes' size,
position and color, height fields' assets) and the same tile origins as
the JAX generator writes into its MjSpec; and the two presets are the JAX
package's, handed out as fresh copies. No compile: the JAX generator's
MjSpec is read as built."""

from __future__ import annotations

import dataclasses

import mujoco
import numpy as np
import pytest

import mjlab_tpu.terrains as jterrains
import mjlab_tpu_torch.terrains as tterrains
from mjlab_tpu.terrains import config as jconfig
from mjlab_tpu_torch.terrains import config as tconfig

# (class name, its arguments): every sub-terrain of the JAX package, with
# the presets' arguments and the random grid's of upstream mjlab.
SUB_TERRAINS = [
  ("BoxFlatTerrainCfg", {}),
  ("BoxPyramidStairsTerrainCfg", dict(step_height_range=(0.0, 0.1), step_width=0.3,
                                      platform_width=3.0, border_width=1.0)),
  ("BoxInvertedPyramidStairsTerrainCfg", dict(step_height_range=(0.0, 0.1), step_width=0.3,
                                              platform_width=3.0, border_width=1.0)),
  ("BoxRandomGridTerrainCfg", dict(grid_width=0.45, grid_height_range=(0.0, 0.1),
                                   platform_width=2.0)),
  ("HfPyramidSlopedTerrainCfg", dict(slope_range=(0.0, 0.4), platform_width=2.0,
                                     border_width=0.25)),
  ("HfInvertedPyramidSlopedTerrainCfg", dict(slope_range=(0.0, 0.4), platform_width=2.0,
                                             border_width=0.25)),
  ("HfRandomUniformTerrainCfg", dict(noise_range=(0.02, 0.10), noise_step=0.02,
                                     border_width=0.25)),
  ("HfWaveTerrainCfg", dict(amplitude_range=(0.0, 0.2), num_waves=4, border_width=0.25)),
]
DIFFICULTIES = (0.05, 0.37, 1.0)
SEEDS = (0, 11)
SIZE = (8.0, 8.0)


def _pair(name: str, proportion: float = 1.0, **kwargs):
  args = dict(dict(SUB_TERRAINS)[name], **kwargs)
  return (getattr(jterrains, name)(proportion=proportion, size=SIZE, **args),
          getattr(tterrains, name)(proportion=proportion, size=SIZE, **args))


def _equal(got, want, what: str) -> None:
  assert np.array_equal(np.asarray(got), np.asarray(want)), what


@pytest.mark.parametrize("difficulty", DIFFICULTIES)
@pytest.mark.parametrize("name", [n for n, _ in SUB_TERRAINS])
def test_sub_terrain_equals_jax(name, difficulty):
  jcfg, tcfg = _pair(name)
  for seed in SEEDS:
    want = jcfg.build(difficulty, np.random.default_rng(seed))
    got = tcfg.build(difficulty, np.random.default_rng(seed))
    _equal(got.origin, want.origin, "origin")
    assert len(got.boxes) == len(want.boxes)
    for i, (g, w) in enumerate(zip(got.boxes, want.boxes)):
      _equal(g.pos, w.pos, f"box {i} pos")
      _equal(g.size, w.size, f"box {i} size")
      assert g.rgba == w.rgba, f"box {i} rgba"
    assert (got.hfield is None) == (want.hfield is None)
    if want.hfield is not None:
      _equal(got.hfield.heights, want.hfield.heights, "heights")
      assert (got.hfield.size_x, got.hfield.size_y, got.hfield.base) == (
        want.hfield.size_x, want.hfield.size_y, want.hfield.base)
    assert (name.startswith("Hf")) == (want.hfield is not None)


def _generator_cfgs(curriculum: bool, color_scheme: str):
  """One JAX and one port generator cfg over every sub-terrain, 3 x 5
  tiles with a border."""
  subs = [_pair(name, proportion=1.0 + i % 3) for i, (name, _) in enumerate(SUB_TERRAINS)]
  common = dict(seed=5, curriculum=curriculum, size=SIZE, border_width=3.0,
                border_height=0.7, num_rows=3, num_cols=5, color_scheme=color_scheme,
                difficulty_range=(0.1, 0.9))
  return (
    jterrains.TerrainGeneratorCfg(sub_terrains={f"s{i}": j for i, (j, _) in enumerate(subs)},
                                  **common),
    tterrains.TerrainGeneratorCfg(sub_terrains={f"s{i}": t for i, (_, t) in enumerate(subs)},
                                  **common),
  )


@pytest.mark.parametrize("color_scheme", ["height", "random"])
@pytest.mark.parametrize("curriculum", [True, False])
def test_generator_equals_jax(curriculum, color_scheme):
  jcfg, tcfg = _generator_cfgs(curriculum, color_scheme)
  jgen = jterrains.TerrainGenerator(jcfg)
  spec = mujoco.MjSpec()
  jgen.build(spec)
  got = tterrains.TerrainGenerator(tcfg).generate()
  _equal(got.terrain_origins, jgen.terrain_origins, "terrain_origins")
  hfields = {h.name: h for h in spec.hfields}
  assert len(got.geoms) == len(spec.geoms)
  assert {g.type for g in got.geoms} == {"box", "hfield"}
  for k, (g, w) in enumerate(zip(got.geoms, spec.geoms)):
    assert w.name == f"terrain_{k}"
    _equal(g.pos, w.pos, f"geom {k} pos")
    _equal(np.asarray(g.rgba, dtype=np.float32), w.rgba, f"geom {k} rgba")
    if g.type == "box":
      assert w.type == mujoco.mjtGeom.mjGEOM_BOX
      _equal(g.size, w.size, f"geom {k} size")
    else:
      assert w.type == mujoco.mjtGeom.mjGEOM_HFIELD
      h = hfields[w.hfieldname]
      assert g.hfield.name == h.name
      _equal(g.hfield.size, h.size, f"hfield {h.name} size")
      assert (g.hfield.nrow, g.hfield.ncol) == (h.nrow, h.ncol)
      _equal(np.asarray(g.hfield.data, dtype=np.float32), h.userdata, f"hfield {h.name}")


@pytest.mark.parametrize("name", ["ROUGH_TERRAINS_CFG", "ROUGH_TERRAINS_WITH_HF_CFG"])
def test_presets_equal_jax_and_are_fresh_copies(name):
  want = dataclasses.asdict(getattr(jconfig, name))
  want.pop("add_lights")
  got = getattr(tconfig, name)
  assert dataclasses.asdict(got) == want
  assert [type(s).__name__ for s in got.sub_terrains.values()] == [
    type(s).__name__ for s in getattr(jconfig, name).sub_terrains.values()]
  got.num_rows = 3
  next(iter(got.sub_terrains.values())).size = (1.0, 1.0)
  assert dataclasses.asdict(getattr(tconfig, name)) == want


def test_the_port_cfg_has_no_light_field():
  """The port reads no light: `add_lights` is left out, and the CLI's
  override of it raises AttributeError."""
  from mjlab_tpu_torch.scripts.cli import apply_overrides

  cfg = tconfig.ROUGH_TERRAINS_CFG
  with pytest.raises(AttributeError):
    apply_overrides(cfg, {"add_lights": "true"})
