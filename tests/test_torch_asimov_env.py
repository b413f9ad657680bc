"""The Asimov velocity-flat env of the PyTorch port against the JAX
package (float64, CPU, 2 envs); the checks are tests/torch_parity.py's
`check_asimov_*`."""

from __future__ import annotations

import pytest

import torch_parity as tp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  return tp.asimov_checked_envs("asimov")


def test_entity_indexing_equal(envs):
  tp.check_asimov_entity_indexing_equal(envs)


def test_constants_and_defaults_equal(envs):
  tp.check_asimov_constants_and_defaults_equal(envs)


def test_observation_and_action_layout_equal(envs):
  tp.check_asimov_observation_and_action_layout_equal(envs)


def test_self_collision_finds_nothing(envs):
  tp.check_asimov_self_collision_finds_nothing(envs)


def test_env_steps_from_a_carried_state(envs):
  tp.check_asimov_env_steps_from_a_carried_state(envs)
