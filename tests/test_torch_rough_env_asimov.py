"""The slice as a whole, Asimov: three env steps of Asimov on rough terrain
(Mjlab-Velocity-Rough-Asimov: the feet's hulls against the terrain pool
through the hull SAT, 30 Newton iterations) of the PyTorch port against
the JAX package (float64, CPU, 2 envs), each from the JAX env's carried
state, to 1e-8 or twice the port's own spread under 1e-13 qpos nudges (its
converged contact solve is ill-conditioned, tests/torch_parity.py
`check_asimov_env_steps_from_a_carried_state`)."""

from __future__ import annotations

import pytest

import chip_smoke
import torch_parity as tp

NUM_ENVS = tp.ASIMOV_NUM_ENVS  # the shared Asimov checks step 2 envs


def _no_corruption(cfg):
  cfg.observations["policy"].enable_corruption = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def asimov():
  jenv, env = tp.rough_envs("asimov", NUM_ENVS, _no_corruption)
  jenv.reset(seed=3)
  return "asimov", jenv, env


def test_asimov_observation_widths_are_the_jax_envs(asimov):
  _, jenv, env = asimov
  want = {g: tuple(int(x) for x in d) for g, d in jenv.observation_manager.group_obs_dim.items()}
  assert env.group_obs_dim == want
  assert (want["policy"][0], want["critic"][0]) == chip_smoke.ROUGH13_OBS_DIMS[
    "Mjlab-Velocity-Rough-Asimov"]
  assert env.sim.model.opt.iterations == jenv.cfg.sim.mujoco.iterations == 30


def test_asimov_env_steps_from_a_carried_state(asimov):
  _, jenv, env = asimov
  tp.check_asimov_env_steps_from_a_carried_state(asimov)
  c = env.data.contact
  assert (c.dist < c.includemargin).any(dim=1).all()  # the feet's hulls on the tiles
