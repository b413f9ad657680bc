"""The slice as a whole, Go1: one env step of Go1 on rough terrain
(Mjlab-Velocity-Rough-Unitree-Go1: the trunk box against the terrain pool
through the hull SAT, the feet and legs through the sphere– and
capsule–box narrowphase) of the PyTorch port against the JAX package
(float64, CPU, 2 envs), from the JAX env's carried state, to 1e-8
(Asimov: tests/test_torch_rough_env_asimov.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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
def go1():
  jenv, env = tp.rough_envs("go1", NUM_ENVS, _no_corruption)
  jenv.reset(seed=3)
  return jenv, env


def test_go1_observation_widths_are_the_jax_envs(go1):
  jenv, env = go1
  want = {g: tuple(int(x) for x in d) for g, d in jenv.observation_manager.group_obs_dim.items()}
  assert env.group_obs_dim == want
  assert (want["policy"][0], want["critic"][0]) == chip_smoke.ROUGH13_OBS_DIMS[
    "Mjlab-Velocity-Rough-Unitree-Go1"]
  assert env.total_action_dim == jenv.action_manager.total_action_dim == 12


def test_go1_one_env_step_from_a_carried_state(go1):
  jenv, env = go1
  tp.carry(jenv, env)
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
  assert "Curriculum/terrain_levels" in text["log"]
  for f in ("qpos", "qvel", "sensordata"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv.data, f)), TOL, f)
  c = env.data.contact
  assert (c.dist < c.includemargin).any(dim=1).all()  # feet on the tiles
