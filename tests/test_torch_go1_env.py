"""The Go1 velocity-flat env (Mjlab-Velocity-Flat-Unitree-Go1) of the
PyTorch port against the JAX package (float64, CPU, 4 envs, the certain-
draw variant): the robot's indexing and one env step from the JAX env's
carried state, to 1e-8. One PPO iteration: tests/test_torch_go1_iteration.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
STEP_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  jenv, env = tp.go1_flat_envs(NUM_ENVS, tp.certain_variant)
  jenv.reset(seed=3)
  return jenv, env


def test_entity_indexing_equal(envs):
  jenv, env = envs
  jr, tr = jenv.scene["robot"], env.scene["robot"]
  assert list(tr.joint_names) == list(jr.joint_names)
  assert list(tr.body_names) == list(jr.body_names)
  assert list(tr.actuator_names) == list(jr.actuator_names)
  assert env.group_obs_dim == {"policy": (48,), "critic": (72,)}
  scale = env.action_manager.get_term("joint_pos").cfg.scale
  assert scale == jenv.action_manager.get_term("joint_pos").cfg.scale


def test_one_env_step_from_a_carried_state(envs):
  jenv, env = envs
  tp.carry(jenv, env)
  a = tp.actions(0, 1, NUM_ENVS, env.total_action_dim)[0]
  jout = tp.numpy_tree(jenv.step(jnp.asarray(a)))
  tout = tp.numpy_tree(env.step(torch.as_tensor(a)))
  (jobs, jrew, jterm, jto, jext), (tobs, trew, tterm, tto, text) = jout, tout
  for g in ("policy", "critic"):
    tp.assert_close(tobs[g], jobs[g], STEP_TOL, g)
  tp.assert_close(trew, jrew, STEP_TOL, "reward")
  np.testing.assert_array_equal(tterm, jterm)
  np.testing.assert_array_equal(tto, jto)
  assert sorted(text["log"]) == sorted(jext["log"])
  for k, v in jext["log"].items():
    tp.assert_close(text["log"][k], v, STEP_TOL, k)
  for f in ("qpos", "qvel", "sensordata"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv.data, f)),
                    STEP_TOL, f)
  # The trunk box against the plane holds its 4 slots among the contacts.
  box = [i for i, p in enumerate(env.tp.pairs) if p.type2 == 6]
  assert len(box) == 1
