"""A G1 tracking env rollout of the PyTorch port against the JAX package
(float64, CPU): 4 envs x 8 env steps on a 15-frame synthetic motion, in a
variant of the task in which every draw is certain (motions start at frame
0, fixed RSI offsets, push every 0.1 s with a fixed velocity, fixed
startup randomization, no observation noise), so that both envs reset on
their own and take the same steps. Every env's motion ends and restarts
inside the rollout (the in-step RSI), and every env is pushed.

Both packages advance each motion clock by two frames per env step: the
masked reset runs every step, and the JAX package's CommandTerm.reset calls
_update_command for every env, masked or not
(mjlab_tpu/managers/command_manager.py:73-78); the reference's reset does
not. A fault of the reference that the port mirrors (ROADMAP Queue C)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
STEPS = 8
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def rollout(tmp_path_factory):
  motion = tp.g1_motion_npz(str(tmp_path_factory.mktemp("motion")), n_frames=10)
  jenv, env = tp.g1_tracking_envs(NUM_ENVS, motion, tp.tracking_certain_variant)
  out = {"jax": [jenv.reset(seed=0)[0]], "port": [env.reset(seed=1)[0]]}
  clocks = {"jax": [], "port": []}
  for a in tp.actions(3, STEPS, NUM_ENVS, env.total_action_dim):
    out["jax"].append(tp.numpy_tree(jenv.step(jnp.asarray(a))))
    out["port"].append(tp.numpy_tree(env.step(torch.as_tensor(a))))
    out["jax"][-1] += ({f: np.asarray(getattr(jenv.data, f))
                        for f in ("qpos", "qvel", "sensordata")},)
    out["port"][-1] += ({f: getattr(env.data, f).numpy()
                         for f in ("qpos", "qvel", "sensordata")},)
    clocks["jax"].append(np.asarray(jenv.state.ms["command"]["motion"]["time_steps"]))
    clocks["port"].append(env.command_manager.get_term("motion").time_steps.numpy())
  return jenv, env, out, clocks


def test_reset_observations_match(rollout):
  _, _, out, _ = rollout
  for g in ("policy", "critic"):
    tp.assert_close(out["port"][0][g].numpy(), out["jax"][0][g], 1e-8, f"reset {g}")


@pytest.mark.parametrize("step", range(STEPS))
def test_rollout_step_matches_jax(rollout, step):
  _, _, out, _ = rollout
  jo, jr, jt, jto, jx, jd = out["jax"][step + 1]
  to, tr, tt, tto, tx, td = out["port"][step + 1]
  np.testing.assert_array_equal(tt, jt)
  np.testing.assert_array_equal(tto, jto)
  for g in ("policy", "critic"):
    tp.assert_close(to[g], jo[g], TOL, g)
  tp.assert_close(tr, jr, TOL, "reward")
  assert sorted(tx["log"]) == sorted(jx["log"])
  for k, v in jx["log"].items():
    tp.assert_close(tx["log"][k], v, TOL, k)
  for f, v in jd.items():
    tp.assert_close(td[f], v, TOL, f)


def test_motion_clocks_wrap_and_advance_two_frames_per_step(rollout):
  jenv, env, _, clocks = rollout
  total = env.command_manager.get_term("motion").motion.time_step_total
  assert total == 15
  j, t = np.stack(clocks["jax"]), np.stack(clocks["port"])
  np.testing.assert_array_equal(t, j)
  # 2 after the reset, 2 more per env step, back to the start past the end.
  want = [2 + 2 * (i + 1) if 2 + 2 * (i + 1) < total else 2 * (i + 1) + 2 - total
          for i in range(STEPS)]
  np.testing.assert_array_equal(t, np.tile(np.asarray(want)[:, None], (1, NUM_ENVS)))
  assert (np.diff(t, axis=0) < 0).any(axis=0).all(), "every env's motion restarts"


def test_final_state_matches_jax(rollout):
  from mjlab_tpu_torch.envs import env_state_to_arrays

  jenv, env, _, _ = rollout
  want, got = tp.jax_env_arrays(jenv), env_state_to_arrays(env)
  keys = [k for k in want if k.startswith(("ms/", "model.")) or k in (
    "episode_length", "common_step_counter")]
  assert {"model.body_ipos", "model.qpos0", "model.geom_friction"} <= set(keys)
  assert any(k.startswith("ms/command/motion/") for k in keys)
  for k in keys:
    tp.assert_close(got[k].astype(np.float64), want[k].astype(np.float64), TOL, k)
  # Pushed every 0.1 s: the push clock fired and was reset.
  assert want["ms/event/interval_time_left/push_robot"].max() <= 0.1 + 1e-12
