"""The PyTorch port's terrain composition (scene/compose.py) against the JAX
package's compiles (float64, CPU).

- The eight committed rough and play scenes, the JAX package's compiles,
  come back from the robots' flat scenes and their tasks' cfgs: integers
  exactly, floats within 1e-12 of each field's largest magnitude
  (`compose.mismatches`; no JAX, no compile).
- Three terrains no npz holds equal a live compile through the JAX scene
  layer's MjSpec (no XLA): a 3 x 4 grid of random-grid tiles at seed 7
  under the random color scheme on Go1, one flat tile with no border on
  Go1 (its one geom at the body's inertial frame, which the compiler still
  marks BODYROT), and ROUGH_TERRAINS_WITH_HF_CFG on Asimov at full grid.
- The read set: every attribute that `put_model`, `Simulation`, the entity
  binding and the env's build read of the composed scene equals the JAX
  compile's, and `put_model` gives the same Topology (pairs, terrain
  groups, slot tables) and Model.
- One `physics.step` of 2 worlds with Asimov's feet on height field tiles
  of the composed scene equals the JAX package's step: qpos within 1e-8;
  qvel within 1e-8, or twice the JAX package's own spread under 2 qpos
  nudges of 1e-13 where that is larger (the repo's rule for
  ill-conditioned solves, as in test_torch_hfield.py): there a 1e-13 nudge
  moves JAX's qvel by ~5e-7.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_tpu.terrains as jterrains
import mjlab_tpu_torch.terrains as tterrains
import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu.terrains import config as jconfig
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets import model_arrays
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import mjtGeom
from mjlab_tpu_torch.scene.compose import RTOL, mismatches
from mjlab_tpu_torch.terrains import config as tconfig

STEP_TOL = 1e-8
NUDGES = 2


def _go1_grid(terrains):
  """A 3 x 4 grid of random-grid tiles at seed 7, random colors, no
  curriculum, in the JAX package's (`jterrains`) or the port's words."""
  return terrains.TerrainGeneratorCfg(
    seed=7, size=(8.0, 8.0), border_width=20.0, num_rows=3, num_cols=4,
    color_scheme="random", curriculum=False,
    sub_terrains={"grid": terrains.BoxRandomGridTerrainCfg(
      proportion=1.0, grid_width=0.45, grid_height_range=(0.0, 0.1), platform_width=2.0)},
  )


def _go1_one_tile(terrains):
  """One flat tile and no border: the terrain body's one geom."""
  return terrains.TerrainGeneratorCfg(
    size=(8.0, 8.0), border_width=0.0, num_rows=1, num_cols=1,
    sub_terrains={"flat": terrains.BoxFlatTerrainCfg(proportion=1.0)},
  )


def _asimov_hf(presets):
  gen = copy.deepcopy(presets.ROUGH_TERRAINS_WITH_HF_CFG)
  gen.curriculum = True
  return gen


# name: (rough scene, the JAX generator cfg, the port's)
CASES = {
  "go1_random_grid": ("go1", lambda: _go1_grid(jterrains), lambda: _go1_grid(tterrains)),
  "go1_one_tile": ("go1", lambda: _go1_one_tile(jterrains), lambda: _go1_one_tile(tterrains)),
  "asimov_hf": ("asimov", lambda: _asimov_hf(jconfig), lambda: _asimov_hf(tconfig)),
}


def _set_generator(gen):
  def edit(cfg):
    cfg.scene.terrain.terrain_generator = gen
  return edit


@pytest.fixture(scope="module")
def compiles():
  """Per case: (the JAX compile through its scene layer, its tile origins,
  the port's composed arrays, the port's env cfg)."""
  from mjlab_tpu.scene import Scene
  from mjlab_tpu_torch.tasks import load_env_cfg

  out = {}
  for case, (robot, jgen, tgen) in CASES.items():
    jcfg = tp.rough_jax_cfg(robot)
    jcfg.scene.terrain.terrain_generator = jgen()
    sc = Scene(jcfg.scene)
    mj = sc.compile()
    jcfg.sim.mujoco.apply(mj)
    tcfg = load_env_cfg(tp.ROUGH[robot][2])
    _set_generator(tgen())(tcfg)
    composed = tp.composed_rough_arrays(robot, edit=_set_generator(tgen()))
    out[case] = (mj, np.asarray(sc.terrain.terrain_origins), composed, tcfg)
  return out


@pytest.mark.parametrize("play", [False, True], ids=["rough", "play"])
@pytest.mark.parametrize("name", list(tp.ROUGH))
def test_composition_equals_the_committed_npz(name, play):
  with np.load(tp.rough_npz(name, play)) as npz:
    want = {k: npz[k] for k in npz.files}
  assert mismatches(want, tp.composed_rough_arrays(name, play)) == []


@pytest.mark.parametrize("case", list(CASES))
def test_composition_equals_a_live_jax_compile(compiles, case):
  mj, origins, composed, _ = compiles[case]
  want = {**model_arrays(mj), "terrain_origins": origins}
  assert mismatches(want, composed) == []
  if case == "asimov_hf":
    assert int(composed["nhfield"]) == 80  # 8 of the 20 columns, 10 rows
  if case == "go1_one_tile":
    box = int(np.flatnonzero(composed["geom_type"] == mjtGeom.mjGEOM_BOX)[0])
    body = int(composed["geom_bodyid"][box])
    g = int(composed["body_geomadr"][body])
    assert int(composed["body_geomnum"][body]) == 1
    assert np.array_equal(composed["geom_pos"][g], composed["body_ipos"][body])
    assert int(composed["geom_sameframe"][g]) == 3  # mjSAMEFRAME_BODYROT


class _Recorder:
  """A compiled scene that records the name of every attribute read of it."""

  def __init__(self, model):
    object.__setattr__(self, "_model", model)
    object.__setattr__(self, "read", set())

  def __getattr__(self, name):
    value = getattr(self._model, name)
    self.read.add(name)
    return value

  def __dir__(self):
    return dir(self._model)


def _same(got, want, what: str) -> None:
  """Equal structures: integers and flags exactly, floats within RTOL of
  the leaf's largest magnitude."""
  if dataclasses.is_dataclass(want):
    assert type(got) is type(want), what
    for f in dataclasses.fields(want):
      _same(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
  elif isinstance(want, dict):
    assert sorted(got, key=str) == sorted(want, key=str), what
    for k in want:
      _same(got[k], want[k], f"{what}[{k}]")
  elif isinstance(want, (list, tuple)):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
      _same(g, w, f"{what}[{i}]")
  elif isinstance(want, (torch.Tensor, np.ndarray)):
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = want.cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, what
    if w.dtype.kind == "f":
      err = float(np.max(np.abs(g - w), initial=0.0))
      assert err <= RTOL * float(np.max(np.abs(w), initial=0.0)), f"{what}: {err:.3e}"
    else:
      assert np.array_equal(g, w), what
  elif isinstance(want, float):
    assert abs(got - want) <= RTOL * abs(want), what
  elif isinstance(want, (int, bool, str, bytes, type(None), torch.dtype, torch.device)):
    assert got == want, what
  else:
    _same(vars(got), vars(want), what)


@pytest.mark.parametrize("case", list(CASES))
def test_the_read_set_equals_jax(compiles, case):
  from mjlab_tpu_torch.assets import model_namespace
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  mj, origins, composed, tcfg = compiles[case]
  live = tp.with_terrain_origins(mj, origins)
  rec = _Recorder(model_namespace(composed))
  cfg = copy.deepcopy(tcfg)
  cfg.scene.num_envs = 2
  cfg.sim.dtype = "float64"
  with tp.torch_threads(1):
    ManagerBasedRlEnv(cfg, device="cpu", model=rec)
  assert {"geom_type", "geom_size", "body_geomadr", "names", "terrain_origins",
          "body_subtreemass"} <= rec.read
  # The env's Simulation sets the cfg's solver options on the model it was
  # given: compare a fresh namespace of the same arrays.
  fresh = model_namespace(composed)
  for name in sorted(rec.read):
    _same(getattr(fresh, name), getattr(live, name), name)
  got = tio.put_model(fresh, dtype=torch.float64, device="cpu")
  want = tio.put_model(live, dtype=torch.float64, device="cpu")
  for g, w, what in zip(got, want, ("topology", "model")):
    _same(g, w, what)


def test_one_hfield_step_equals_jax(compiles):
  """Asimov standing on a random-bump tile and on a wave tile, its feet in
  contact with the height field."""
  from mjlab_tpu_torch.assets import model_namespace

  mj, origins, composed, _ = compiles["asimov_hf"]
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(model_namespace(composed), dtype=torch.float64, device="cpu")
  assert ttp.pairs and all(p.type1 == mjtGeom.mjGEOM_HFIELD for p in ttp.pairs)
  q = np.tile(mj.key_qpos[0], (2, 1))
  for w, (row, col) in enumerate([(3, 15), (6, 18)]):  # random_rough, wave
    q[w, :3] = origins[row, col] + np.array([0.3, -0.2, mj.key_qpos[0][2] - 0.02])
  d0 = jphysics.make_data(jtp, jm)
  states = tp.jax_data_arrays(jax.vmap(lambda qq: d0.replace(qpos=qq))(jnp.asarray(q)))
  step = jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))
  want = tp.jax_data_arrays(step(tp.jax_data_from_arrays(states)))
  rng = np.random.default_rng(0)
  spread = [tp.jax_data_arrays(step(tp.jax_data_from_arrays(dict(states, qpos=states["qpos"] * (
    1 + 1e-13 * rng.normal(size=states["qpos"].shape)))))) for _ in range(NUDGES)]
  with tp.torch_threads(1):
    got = tio.data_to_arrays(tphysics.step(ttp, tm, tp.to_torch(states)))
  hfield_slots = sum(p.ncon for p in ttp.pairs)
  active = want["contact.dist"] < want["contact.includemargin"]
  assert active[:, :hfield_slots].any(axis=1).all(), active.sum(axis=1)
  for f in ("contact.dist", "contact.pos", "contact.frame"):
    tp.assert_close(got[f][active], want[f][active], 1e-9, f)
  tp.assert_close(got["qpos"], want["qpos"], STEP_TOL, "qpos")
  scale = max(1.0, float(np.max(np.abs(want["qvel"]))))
  far = max(float(np.max(np.abs(s["qvel"] - want["qvel"]))) for s in spread)
  tp.assert_close(got["qvel"], want["qvel"], max(STEP_TOL, 2 * far / scale), "qvel")
