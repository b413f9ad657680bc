"""The G1 velocity task's MDP terms in the PyTorch port against the JAX
package (float64, CPU): every observation, reward (weighted) and
termination term on a state carried from the JAX env, and the stateful
terms' state after 5 carried env steps.

The feet contact sensor here matches the compiled terrain body "/terrain"
in both packages (the task's own pattern, "terrain", matches nothing in
either), so that the contact-driven terms see contacts."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
TOL = 1e-9


def _ground(cfg):
  cfg.scene.sensors[0].secondary.pattern = "/terrain"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  jenv, env = tp.g1_flat_envs(NUM_ENVS, _ground)
  jenv.reset(seed=5)
  tp.carry(jenv, env)
  for a in tp.actions(1, 5, NUM_ENVS, env.total_action_dim):
    jenv.step(jnp.asarray(a))
    env.step(torch.as_tensor(a))
  return jenv, env


@pytest.fixture()
def carried(envs):
  """Both envs on the JAX env's state with complete Data."""
  jenv, env = envs
  tp.carry(jenv, env, full=True)
  jenv.step_log, env.step_log = {}, {}
  return jenv, env


def _terms(cfg_dict):
  return [(n, c) for n, c in cfg_dict.items() if c is not None]


def test_stateful_terms_agree_after_5_carried_steps(envs):
  from mjlab_tpu_torch.envs import env_state_to_arrays

  jenv, env = envs
  want, got = tp.jax_env_arrays(jenv), env_state_to_arrays(env)
  keys = [k for k in want if k.startswith(("ms/reward/term_state", "ms/scene/sensors"))]
  assert any("peak_heights" in k for k in keys) and any("air_time" in k for k in keys)
  for k in keys:
    tp.assert_close(got[k], want[k], 1e-8, k)
  # The feet touched down and lifted off within the window.
  assert want["ms/scene/sensors/feet_ground_contact/last_contact_time"].max() > 0


@pytest.mark.parametrize("group", ["policy", "critic"])
def test_observation_terms(carried, group):
  jenv, env = carried
  jg, tg = jenv.cfg.observations[group], env.cfg.observations[group]
  assert [n for n, _ in _terms(jg.terms)] == [n for n, _ in _terms(tg.terms)]
  for (name, jc), (_, tc) in zip(_terms(jg.terms), _terms(tg.terms)):
    want = jc.func(jenv, **jc.params)
    got = tc.func(env, **tc.params)
    tp.assert_close(got.numpy(), want, TOL, f"{group}/{name}")


def test_reward_terms_weighted(carried):
  jenv, env = carried
  names = [n for n, _ in _terms(env.cfg.rewards)]
  assert names == [n for n, _ in _terms(jenv.cfg.rewards)] and len(names) == 14
  nonzero = 0
  for name in names:
    jc, tc = jenv.cfg.rewards[name], env.cfg.rewards[name]
    want = np.asarray(jc.func(jenv, **jc.params)) * jc.weight
    got = tc.func(env, **tc.params).numpy() * tc.weight
    tp.assert_close(got, want, TOL, name)
    nonzero += bool(np.any(want != 0))
  assert nonzero >= 10
  assert sorted(env.step_log) == sorted(jenv.step_log)
  for k in jenv.step_log:
    tp.assert_close(env.step_log[k].numpy(), jenv.step_log[k], TOL, k)
  # The stateful term's update agrees too.
  k = "ms/reward/term_state/foot_swing_height/peak_heights"
  from mjlab_tpu_torch.envs import env_state_to_arrays

  tp.assert_close(env_state_to_arrays(env)[k], tp.jax_env_arrays(jenv)[k], TOL, k)


def test_termination_terms(carried):
  jenv, env = carried
  for (name, jc), (_, tc) in zip(_terms(jenv.cfg.terminations),
                                 _terms(env.cfg.terminations)):
    np.testing.assert_array_equal(tc.func(env, **tc.params).numpy(),
                                  np.asarray(jc.func(jenv, **jc.params)), err_msg=name)


def test_command_update_and_curriculum(carried):
  jenv, env = carried
  jterm, tterm = (e.command_manager.get_term("twist") for e in (jenv, env))
  jterm._update_command()
  tterm._update_command()
  tp.assert_close(tterm.command.numpy(), jterm.command, TOL, "vel_command_b")
  jterm._update_metrics()
  tterm._update_metrics()
  for k in jterm.state["metrics"]:
    tp.assert_close(tterm.state["metrics"][k].numpy(), jterm.state["metrics"][k], TOL, k)
  jc, tc = jenv.cfg.curriculum["command_vel"], env.cfg.curriculum["command_vel"]
  mask = np.ones(NUM_ENVS, dtype=bool)
  want = jc.func(jenv, jnp.asarray(mask), **jc.params)
  got = tc.func(env, torch.as_tensor(mask), **tc.params)
  assert list(got) == list(want)
  for k in want:
    tp.assert_close(got[k].numpy(), want[k], 0.0, k)
