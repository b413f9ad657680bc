"""The G1 velocity-flat env step of the PyTorch port against the JAX
package (float64, CPU), on the real task cfg with observation corruption
off: the JAX env is reset, its whole state (random commands, per-env foot
friction, interval timers) is carried into the port, and both step with the
same seeded actions. The seed leaves the window free of resets and of
command and push expiries, so that every draw falls outside it."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
STEPS = 25
SEED = 3


def _no_corruption(cfg):
  cfg.observations["policy"].enable_corruption = False


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  jenv, env = tp.g1_flat_envs(NUM_ENVS, _no_corruption)
  jenv.reset(seed=SEED)
  return jenv, env


def _compare(jout, tout, jenv, env, tol: float) -> dict[str, float]:
  """Step outputs and physics state; returns the largest error of each."""
  (jobs, jrew, jterm, jtout, jext), (tobs, trew, tterm, ttout, text) = (
    tp.numpy_tree(jout), tp.numpy_tree(tout)
  )
  errs = {}
  for g in ("policy", "critic"):
    errs[g] = tp.assert_close(tobs[g], jobs[g], tol, g)
  errs["reward"] = tp.assert_close(trew, jrew, tol, "reward")
  np.testing.assert_array_equal(tterm, jterm)
  np.testing.assert_array_equal(ttout, jtout)
  assert int(text["log"]["reset_count"]) == int(jext["log"]["reset_count"])
  assert sorted(text["log"]) == sorted(jext["log"])
  for k, v in jext["log"].items():
    errs[k] = tp.assert_close(text["log"][k], v, tol, k)
  for f in ("qpos", "qvel", "sensordata"):
    errs[f] = tp.assert_close(getattr(env.data, f).numpy(),
                              np.asarray(getattr(jenv.data, f)), tol, f)
  return errs


def test_one_env_step_from_a_carried_state(envs):
  jenv, env = envs
  tp.carry(jenv, env)
  a = tp.actions(0, 1, NUM_ENVS, env.total_action_dim)[0]
  errs = _compare(jenv.step(jnp.asarray(a)), env.step(torch.as_tensor(a)), jenv, env, 1e-8)
  assert max(errs.values()) >= 0.0


def test_rollout_25_env_steps(envs):
  jenv, env = envs
  jenv.reset(seed=SEED)
  start = tp.carry(jenv, env)
  # No command or push clock runs out, and nothing resets, in the window.
  step_dt = env.step_dt
  assert start["ms/command/twist/time_left"].min() > (STEPS + 1) * step_dt
  assert start["ms/event/interval_time_left/push_robot"].min() > (STEPS + 1) * step_dt
  assert start["ms/command/twist/vel_command_b"].std() > 0.1  # random commands
  fric = start["model.geom_friction"][..., 0]
  assert np.ptp(fric, axis=0).max() > 0.1  # per-env foot friction
  for a in tp.actions(2, STEPS, NUM_ENVS, env.total_action_dim):
    jout = jenv.step(jnp.asarray(a))
    tout = env.step(torch.as_tensor(a))
    _compare(jout, tout, jenv, env, 1e-6)
    assert not np.asarray(jout[2]).any() and not np.asarray(jout[3]).any()
