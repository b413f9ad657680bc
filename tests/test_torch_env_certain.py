"""The G1 velocity-flat env of the PyTorch port against the JAX package
(float64, CPU) through resets, commands resampling, pushes and the
curriculum, on a variant of the task in which every draw is certain:
zero-width command, reset, push, friction and clock ranges, no standing
envs, all heading envs, no observation noise. Both envs are built and
reset on their own; with 0.3 s episodes (15 env steps) and a 0.4 s push
clock, 50 env steps reset every env 3 times and push it twice."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

NUM_ENVS = 4
STEPS = 50


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def envs():
  return tp.g1_flat_envs(NUM_ENVS, tp.certain_variant)


def test_certain_rollout_through_resets_and_pushes(envs):
  from mjlab_tpu_torch.envs import env_state_to_arrays

  jenv, env = envs
  jobs, _ = jenv.reset(seed=0)
  tobs, _ = env.reset(seed=1)  # another seed: no draw may matter
  for g in ("policy", "critic"):
    tp.assert_close(tobs[g].numpy(), jobs[g], 1e-8, f"reset {g}")
  resets = np.zeros(NUM_ENVS, dtype=int)
  pushes = np.zeros(NUM_ENVS, dtype=int)
  clock = np.asarray(jenv.state.ms["event"]["interval_time_left"]["push_robot"])
  for i, a in enumerate(tp.actions(3, STEPS, NUM_ENVS, env.total_action_dim)):
    (jo, jr, jt, jto, jx) = tp.numpy_tree(jenv.step(jnp.asarray(a)))
    (to, tr, tt, tto, tx) = tp.numpy_tree(env.step(torch.as_tensor(a)))
    np.testing.assert_array_equal(tt, jt, err_msg=f"terminated, step {i}")
    np.testing.assert_array_equal(tto, jto, err_msg=f"time_outs, step {i}")
    assert int(tx["log"]["reset_count"]) == int(jx["log"]["reset_count"])
    for g in ("policy", "critic"):
      tp.assert_close(to[g], jo[g], 1e-6, f"{g}, step {i}")
    tp.assert_close(tr, jr, 1e-6, f"reward, step {i}")
    assert sorted(tx["log"]) == sorted(jx["log"])
    for k, v in jx["log"].items():
      tp.assert_close(tx["log"][k], v, 1e-6, f"{k}, step {i}")
    for f in ("qpos", "qvel", "sensordata"):
      tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jenv.data, f)),
                      1e-6, f"{f}, step {i}")
    resets += jt | jto
    new_clock = np.asarray(jenv.state.ms["event"]["interval_time_left"]["push_robot"])
    pushes += new_clock > clock
    clock = new_clock
  assert resets.min() >= 3 and pushes.min() >= 2, (resets, pushes)
  # The whole carried state agrees at the end, counters exactly.
  want, got = tp.jax_env_arrays(jenv), env_state_to_arrays(env)
  for k, v in want.items():
    if k.startswith("ms/") or k in ("episode_length", "common_step_counter",
                                    "model.geom_friction"):
      tp.assert_close(got[k].astype(np.float64), v.astype(np.float64), 1e-6, k)
  np.testing.assert_array_equal(got["episode_length"], want["episode_length"])
