"""The terrain importer and the terrain-level curriculum of the PyTorch port
against the JAX package: the initial levels and types and the env origins
they give, `update_env_origins`, and `terrain_levels_vel` over seeded robot
positions and commands, exactly. And the fault both packages share
(ROADMAP Queue C): a promoted env's level rises, but its env origin, where
a reset places it, stays on its first tile."""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.tasks import load_env_cfg
from mjlab_tpu_torch.terrains import TerrainImporter

NUM_ENVS = 64
TASK = "Mjlab-Velocity-Rough-Unitree-G1"


class _Ctx:
  """What the importers read of their env: dtype, device, namespaces."""

  def __init__(self, dtype, device=None):
    self.dtype, self.device, self._ns = dtype, device, {"scene": {}}

  def ns(self, name):
    return self._ns[name]


def _importers():
  from mjlab_tpu.terrains import TerrainImporter as JaxImporter

  jcfg = tp.rough_jax_cfg("g1").scene.terrain
  jcfg.num_envs = NUM_ENVS
  jimp = JaxImporter(jcfg)
  jctx = _Ctx(jnp.float64)
  jimp.initialize(jctx)
  jctx.ns("scene")["terrain"] = jimp.init_state()

  tcfg = load_env_cfg(TASK).scene.terrain
  origins = assets.load_model_npz(assets.G1_VELOCITY_ROUGH).terrain_origins
  timp = TerrainImporter(tcfg, NUM_ENVS, 2.0, origins)
  tctx = _Ctx(torch.float64, "cpu")
  timp.initialize(tctx)
  tctx.ns("scene")["terrain"] = timp.init_state()
  return jimp, timp


def test_cfg_matches_jax():
  jcfg, tcfg = tp.rough_jax_cfg("g1").scene.terrain, load_env_cfg(TASK).scene.terrain
  assert (tcfg.terrain_type, tcfg.max_init_terrain_level) == ("generator", 5)
  assert (jcfg.terrain_type, jcfg.max_init_terrain_level) == ("generator", 5)
  for f in ("size", "num_rows", "num_cols", "curriculum"):
    assert getattr(tcfg.terrain_generator, f) == getattr(jcfg.terrain_generator, f), f
  assert tcfg.terrain_generator.curriculum is True


def test_initial_levels_types_and_origins_match_jax():
  jimp, timp = _importers()
  np.testing.assert_array_equal(timp.terrain_origins, jimp.terrain_origins)
  for k, v in jimp.init_state().items():
    got = timp.init_state()[k]
    assert got.dtype == torch.int32, k
    np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)
  np.testing.assert_array_equal(timp.env_origins.numpy(), np.asarray(jimp.env_origins))
  assert timp.max_terrain_level == jimp.max_terrain_level == 10
  levels = timp.terrain_levels.numpy()
  assert levels.min() == 0 and levels.max() == 5  # below max_init_terrain_level + 1


def test_update_env_origins_matches_jax():
  jimp, timp = _importers()
  rng = np.random.default_rng(0)
  for _ in range(12):
    mask, up, down = (rng.random(NUM_ENVS) < p for p in (0.7, 0.5, 0.3))
    jimp.update_env_origins(jnp.asarray(mask), jnp.asarray(up), jnp.asarray(down))
    timp.update_env_origins(*(torch.as_tensor(x) for x in (mask, up, down)))
    np.testing.assert_array_equal(timp.terrain_levels.numpy(),
                                  np.asarray(jimp.terrain_levels))
  levels = timp.terrain_levels.numpy()
  assert levels.min() == 0 and levels.max() == 9  # clamped at both ends


def _fake_env(imp, pos, command, array):
  """What terrain_levels_vel reads of an env: the robot's root position,
  the scene's terrain and env origins, the command and the episode
  length."""

  class Scene(SimpleNamespace):
    def __getitem__(self, name):
      return self.entities[name]

  robot = SimpleNamespace(data=SimpleNamespace(root_link_pos_w=array(pos)))
  scene = Scene(entities={"robot": robot}, terrain=imp, env_origins=imp.env_origins)
  commands = SimpleNamespace(get_command=lambda name: array(command))
  return SimpleNamespace(scene=scene, command_manager=commands, max_episode_length_s=20.0,
                         dtype=imp._ctx.dtype)


def test_terrain_levels_vel_matches_jax():
  from mjlab_tpu.tasks.velocity.mdp import terrain_levels_vel as jax_levels
  from mjlab_tpu_torch.tasks.velocity.mdp import terrain_levels_vel

  jimp, timp = _importers()
  rng = np.random.default_rng(1)
  moved = 0
  for _ in range(6):
    before = timp.terrain_levels.numpy().copy()
    # Walked 0-8 m from the origin (> 4 m, half a tile, promotes); commands
    # up to 1 m/s over 20 s episodes (< half the commanded distance demotes).
    walked = rng.uniform(0.0, 8.0, NUM_ENVS)
    angle = rng.uniform(-np.pi, np.pi, NUM_ENVS)
    pos = np.asarray(jimp.env_origins) + np.stack(
      [walked * np.cos(angle), walked * np.sin(angle), np.full(NUM_ENVS, 0.76)], -1
    )
    command = rng.uniform(-1.0, 1.0, (NUM_ENVS, 3))
    mask = rng.random(NUM_ENVS) < 0.8
    want = jax_levels(_fake_env(jimp, pos, command, jnp.asarray), jnp.asarray(mask), "twist")
    got = terrain_levels_vel(_fake_env(timp, pos, command, torch.as_tensor),
                             torch.as_tensor(mask), "twist")
    np.testing.assert_array_equal(timp.terrain_levels.numpy(),
                                  np.asarray(jimp.terrain_levels))
    assert got.dtype == torch.float64 and float(got) == float(want)
    moved += int((timp.terrain_levels.numpy() != before).sum())
  assert moved > NUM_ENVS  # both directions, many envs


def test_promoted_env_origin_stays_on_its_first_tile():
  """The shared fault: the curriculum moves the level, but env_origins —
  what a reset reads — never follows it, in either package."""
  jimp, timp = _importers()
  first = timp.env_origins.clone()
  init_levels = timp.terrain_levels.numpy().copy()
  up = np.ones(NUM_ENVS, dtype=bool)
  for _ in range(3):
    jimp.update_env_origins(jnp.asarray(up), jnp.asarray(up), jnp.asarray(~up))
    timp.update_env_origins(*(torch.as_tensor(x) for x in (up, up, ~up)))
  for imp, levels, origins in ((timp, timp.terrain_levels.numpy(), timp.env_origins.numpy()),
                               (jimp, np.asarray(jimp.terrain_levels),
                                np.asarray(jimp.env_origins))):
    assert (levels == np.minimum(init_levels + 3, 9)).all()
    np.testing.assert_array_equal(origins, first.numpy())
    types = np.arange(NUM_ENVS) % imp.terrain_origins.shape[1]
    promoted_tile = imp.terrain_origins[levels, types]
    # The next tile lies 8 m further along x; the env's origin has not moved.
    assert np.abs(promoted_tile[:, 0] - origins[:, 0]).min() >= 8.0 - 1e-9


@pytest.mark.parametrize("field,value", [("num_rows", 3), ("num_cols", 21)])
def test_a_grid_other_than_the_scenes_raises(field, value):
  """Any grid builds: an env on a grid no committed scene holds has the
  arrays (compose.mismatches) and the tiles' and envs' origins of the JAX
  package's compile of the same cfg."""
  from mjlab_tpu.scene import Scene as JaxScene
  from mjlab_tpu_torch.assets import model_arrays
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.scene.compose import mismatches

  cfg = load_env_cfg(TASK)
  cfg.scene.num_envs = 2
  setattr(cfg.scene.terrain.terrain_generator, field, value)
  with tp.torch_threads(1):
    env = ManagerBasedRlEnv(cfg, device="cpu")
  jcfg = tp.rough_jax_cfg("g1")
  jcfg.scene.num_envs = 2
  setattr(jcfg.scene.terrain.terrain_generator, field, value)
  jscene = JaxScene(jcfg.scene)
  mj = jscene.compile()
  jcfg.sim.mujoco.apply(mj)
  want = {**model_arrays(mj), "terrain_origins": np.asarray(jscene.terrain.terrain_origins)}
  assert mismatches(want, model_arrays(env.scene._model)) == []
  np.testing.assert_array_equal(env.scene.terrain.terrain_origins, want["terrain_origins"])
  jscene.terrain.initialize(_Ctx(jnp.float64))
  np.testing.assert_array_equal(env.scene.env_origins.numpy(), np.asarray(jscene.terrain.env_origins))
  assert env.scene.terrain.terrain_origins.shape[:2] == (
    (3, 20) if field == "num_rows" else (10, 21))
