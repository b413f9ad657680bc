"""One PPO iteration of the Go1 velocity-flat task (Mjlab-Velocity-Flat-
Unitree-Go1) in the PyTorch port against the JAX package: the Go1 rl cfg
(hidden 512/256/128, no observation normalization), 4 envs in float64 on
the certain-draw variant, T = 16, 2 epochs x 2 minibatches, from one state
with JAX's draws (tests/torch_parity.py `iteration_pair`), within the
runner test's 1e-6 (tests/test_torch_runner.py says why)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch_parity as tp
from mjlab_tpu.tasks.velocity.config.go1.rl_cfg import UnitreeGo1PPORunnerCfg
from mjlab_tpu_torch.rl import ppo as tppo
from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
from mjlab_tpu_torch.tasks import load_rl_cfg

TASK = "Mjlab-Velocity-Flat-Unitree-Go1"
NUM_ENVS = 4
T = 16
ITER_TOL = 1e-6


def _rl_cfg(cfg):
  cfg.seed = 0
  cfg.num_steps_per_env = T
  cfg.algorithm.num_learning_epochs = 2
  cfg.algorithm.num_mini_batches = 2
  return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


@pytest.fixture(scope="module")
def run():
  jenv, env = tp.go1_flat_envs(NUM_ENVS, tp.certain_variant)
  return tp.iteration_pair(jenv, env, _rl_cfg(UnitreeGo1PPORunnerCfg()),
                           _rl_cfg(load_rl_cfg(TASK)), T)


def test_iteration_rollout_matches_jax(run):
  jb, tb = run["jbatch"], run["tbatch"]
  done = np.asarray(jb.done)
  assert done.any(axis=0).all(), "every env resets inside the rollout"
  np.testing.assert_array_equal(tb.done.numpy(), done)
  for f in dataclasses.fields(tppo.Transition):
    if f.name != "done":
      tp.assert_close(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)),
                      ITER_TOL, f.name)


def test_iteration_learner_and_metrics_match_jax(run):
  for what, (j, t) in (("advantages", run["adv"]), ("returns", run["ret"])):
    tp.assert_close(t.numpy(), j, ITER_TOL, what)
  want = tp.jax_runner_arrays(run["jstate"])
  got = runner_state_to_arrays(run["tr"])
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    tp.assert_close(got[k].astype(np.float64), v.astype(np.float64), ITER_TOL, k)
  jmet, tmet = run["jmet"], run["tmet"]
  assert sorted(tmet) == sorted(jmet)
  for k, v in jmet.items():
    tp.assert_close(tmet[k].numpy().astype(np.float64), np.asarray(v, np.float64), ITER_TOL, k)
  assert np.isfinite(float(tmet["Loss/loss"]))
