"""The slice as a whole: one G1 rough env step (Mjlab-Velocity-Rough-
Unitree-G1: the box-terrain contacts, the terrain-level curriculum, the
terrain state) of the PyTorch port against the JAX package (float64, CPU,
2 envs), from the JAX env's carried state, to 1e-8; and the curriculum
fault both packages share, at the env level: after a reset the robot
stands at its first tile's origin whatever its level (ROADMAP Queue C)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 2
TOL = 1e-8


def _no_corruption(cfg):
  cfg.observations["policy"].enable_corruption = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  jenv, env = tp.rough_envs("g1", NUM_ENVS, _no_corruption)
  jenv.reset(seed=3)
  return jenv, env


def test_one_env_step_from_a_carried_state(envs):
  jenv, env = envs
  start = tp.carry(jenv, env)
  assert start["ms/scene/terrain/terrain_levels"].dtype == np.int32
  np.testing.assert_array_equal(env.scene.env_origins.numpy(), np.asarray(jenv.scene.env_origins))
  a = tp.actions(0, 1, NUM_ENVS, env.total_action_dim)[0]
  jout = tp.numpy_tree(jenv.step(jnp.asarray(a)))
  tout = tp.numpy_tree(env.step(torch.as_tensor(a)))
  (jobs, jrew, jterm, jto, jext), (tobs, trew, tterm, tto, text) = jout, tout
  for g in ("policy", "critic"):
    tp.assert_close(tobs[g], jobs[g], TOL, g)
  tp.assert_close(trew, jrew, TOL, "reward")
  np.testing.assert_array_equal(tterm, jterm)
  np.testing.assert_array_equal(tto, jto)
  assert sorted(text["log"]) == sorted(jext["log"])
  for k, v in jext["log"].items():
    tp.assert_close(text["log"][k], v, TOL, k)
  assert text["log"]["Metrics/physics/terrain_slots_dropped"] == 0.0
  assert "Curriculum/terrain_levels" in text["log"]
  for f in ("qpos", "qvel", "sensordata"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv.data, f)), TOL, f)
  c = env.data.contact
  terrain = slice(sum(p.ncon for p in env.tp.pairs), None)
  assert (c.dist[:, terrain] < c.includemargin[:, terrain]).any(dim=1).all()  # feet on tiles


def test_a_reset_places_the_robot_on_its_first_tile_at_any_level(envs):
  jenv, env = envs
  st = env.scene.terrain.state
  st["terrain_levels"] = torch.full_like(st["terrain_levels"], 9)
  ms = jax.tree_util.tree_map(lambda x: x, jenv.state.ms)
  ms["scene"]["terrain"]["terrain_levels"] = jnp.full((NUM_ENVS,), 9, jnp.int32)
  jenv.state = jenv.state.replace(ms=ms)
  jenv.reset(seed=4)
  env.reset(seed=4)
  origins = env.scene.env_origins.numpy()
  tiles = env.scene.terrain.terrain_origins
  types = np.arange(NUM_ENVS) % tiles.shape[1]
  for levels, root in ((env.scene.terrain.terrain_levels.numpy(), env.data.qpos.numpy()[:, :2]),
                       (np.asarray(jenv._ms["scene"]["terrain"]["terrain_levels"]),
                        np.asarray(jenv.data.qpos)[:, :2])):
    assert (levels >= 8).all()  # the reset's curriculum demotes by one at most
    near = np.linalg.norm(root - origins[:, :2], axis=-1)
    assert (near <= 0.75).all(), near  # the reset pose range is ±0.5 m
    far = np.linalg.norm(root - tiles[levels, types][:, :2], axis=-1)
    assert (far >= 8.0).all(), far  # nowhere near the level's own tile


def test_a_terrain_sensor_matches_the_pools_slots(envs):
  """A feet sensor whose secondary is the compiled "/terrain" body (the task's
  "terrain" never matches, ROADMAP Queue C) takes the terrain groups' slots
  (their geom1 ranges over the whole pool): its slot table equals the JAX
  sensor's, and so do its readings on one state (1e-8)."""
  from mjlab_tpu.sensors import ContactMatch as JaxMatch
  from mjlab_tpu.sensors import ContactSensorCfg as JaxSensorCfg
  from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg

  jenv, env = envs
  kw = dict(name="feet_terrain", fields=("found", "force"), reduce="netforce")
  feet = r"^(left_ankle_roll_link|right_ankle_roll_link)$"
  jsensor = JaxSensorCfg(primary=JaxMatch(mode="subtree", pattern=feet, entity="robot"),
                         secondary=JaxMatch(mode="body", pattern="/terrain"), **kw).build()
  tsensor = ContactSensorCfg(primary=ContactMatch(mode="subtree", pattern=feet, entity="robot"),
                             secondary=ContactMatch(mode="body", pattern="/terrain"), **kw).build()
  jsensor.initialize(jenv.sim.mj_model, jenv)
  tsensor.initialize(env.scene._model, env)
  for f in ("_slot_idx", "_slot_valid", "_slot_sign"):
    np.testing.assert_array_equal(getattr(tsensor, f), getattr(jsensor, f), err_msg=f)
  static = sum(p.ncon for p in env.tp.pairs)
  assert (tsensor._slot_idx[tsensor._slot_valid] >= static).all()  # terrain slots only
  assert tsensor._slot_valid.sum() == 2 * 7 * 6  # 7 foot spheres/capsules per foot, 6 slots
  # The JAX env's state after one more step, with its derived fields (one
  # forward: contacts and constraint forces), carried whole into the port.
  jenv.step(jnp.asarray(tp.actions(1, 1, NUM_ENVS, env.total_action_dim)[0]))
  tp.carry(jenv, env, full=True)
  jdata, tdata = jsensor.data, tsensor.data
  assert float(tdata.found.sum()) > 0  # the feet stand on the tiles
  for f in ("found", "force"):
    tp.assert_close(getattr(tdata, f).numpy(), np.asarray(getattr(jdata, f)), TOL, f)
