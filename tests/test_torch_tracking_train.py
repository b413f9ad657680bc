"""One PPO training iteration of the G1 tracking task in the PyTorch port
against the JAX package (float64 env, CPU), as tests/test_torch_runner.py
holds the velocity task: the certain-draw tracking variant, 4 envs, a
rollout of T = 8 on a 15-frame synthetic motion (every env's motion
restarts inside the rollout), 2 epochs x 2 minibatches, the G1 tracking
PPO cfg's real widths (512/256/128, observation normalization, entropy
0.005).

Both runners start from the JAX runner's state (env state, observations,
a float64 learner with normalizers of nonzero count) and take JAX's draws.
Tolerance 1e-6 relative to max(1, max |JAX|), for the float32 observation
cast both runners make (tests/test_torch_runner.py)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu.rl import ppo as jppo
from mjlab_tpu.rl.networks import ActorCritic as JaxActorCritic
from mjlab_tpu.rl.networks import RunningNorm as JaxRunningNorm
from mjlab_tpu.rl.runner import OnPolicyRunner as JaxRunner
from mjlab_tpu.tasks.tracking.config.g1.rl_cfg import G1FlatPPORunnerCfg
from mjlab_tpu_torch.rl import ppo as tppo
from mjlab_tpu_torch.rl.runner import (
  OnPolicyRunner,
  runner_state_from_arrays,
  runner_state_to_arrays,
)
from mjlab_tpu_torch.tasks import load_rl_cfg

NUM_ENVS = 4
T = 8
TOL = 1e-6


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
def run(tmp_path_factory):
  motion = tp.g1_motion_npz(str(tmp_path_factory.mktemp("motion")), n_frames=10)
  jenv, env = tp.g1_tracking_envs(NUM_ENVS, motion, tp.tracking_certain_variant)
  jr = JaxRunner(jenv, _rl_cfg(G1FlatPPORunnerCfg()))
  tr = OnPolicyRunner(env, _rl_cfg(load_rl_cfg("Mjlab-Tracking-Flat-Unitree-G1")))

  rng = np.random.default_rng(0)

  def norm(dim):
    return JaxRunningNorm(mean=jnp.asarray(rng.normal(0, 0.5, dim)),
                          var=jnp.asarray(rng.uniform(0.5, 2.0, dim)),
                          count=jnp.asarray(200.0))

  state = tp.jax_learner_f64(jr.state).replace(
    actor_norm=norm(tr.num_actor_obs), critic_norm=norm(tr.num_critic_obs)
  )
  tp.carry(jenv, env)
  runner_state_from_arrays(tr, tp.jax_runner_arrays(state))
  tr.obs = {k: torch.tensor(np.asarray(v)) for k, v in state.obs.items()}

  rng_next, scan_key = jax.random.split(state.rng)
  keys = jax.random.split(scan_key, T)
  noise = np.stack([np.asarray(jax.random.normal(k, (NUM_ENVS, tr.num_actions), jnp.float64))
                    for k in keys])
  perms = []
  train_rng = state.train.rng
  for _ in range(2):
    train_rng, key = jax.random.split(train_rng)
    perms.append(np.asarray(jax.random.permutation(key, T * NUM_ENVS)))

  carry = (state.env_state, state.obs, state.train.params, state.actor_norm, state.critic_norm)
  carry, (jbatch, extras) = jax.jit(lambda c, k: jax.lax.scan(jr._rollout_step, c, k))(
    carry, keys
  )
  jstate, jmet = jax.jit(jr._post_rollout)(state, carry, jbatch, extras, rng_next)
  last_c_obs = state.critic_norm(carry[1]["critic"].astype(jnp.float32))
  jlast = jr.ac.apply(state.train.params, last_c_obs, method=JaxActorCritic.value)
  _, jadv, jret = jppo.prepare_update(jr.cfg.algorithm, jbatch, jlast)

  tbatch, logs = tr.rollout(torch.as_tensor(noise))
  with torch.no_grad():
    tlast = tr.ac.value(tr.critic_norm(tr.obs["critic"].to(torch.float32)))
  _, tadv, tret = tppo.prepare_update(tr.cfg.algorithm, tbatch, tlast)
  tmet = tr.update(tbatch, logs, torch.as_tensor(np.stack(perms)))
  return dict(tr=tr, jstate=jstate, jmet=jmet, jbatch=jbatch, tbatch=tbatch, tmet=tmet,
              adv=(jadv, tadv), ret=(jret, tret))


def test_observation_widths(run):
  assert (run["tr"].num_actor_obs, run["tr"].num_critic_obs) == (160, 286)


def test_rollout_matches_jax(run):
  jb, tb = run["jbatch"], run["tbatch"]
  np.testing.assert_array_equal(tb.done.numpy(), np.asarray(jb.done))
  for f in dataclasses.fields(tppo.Transition):
    if f.name != "done":
      tp.assert_close(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)), TOL, f.name)


def test_advantages_and_returns_match_jax(run):
  for what, (j, t) in (("advantages", run["adv"]), ("returns", run["ret"])):
    tp.assert_close(t.numpy(), j, TOL, what)


def test_learner_state_matches_jax(run):
  want = tp.jax_runner_arrays(run["jstate"])
  got = runner_state_to_arrays(run["tr"])
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    tp.assert_close(got[k].astype(np.float64), v.astype(np.float64), TOL, k)
  assert int(got["opt/count"]) == 4


def test_metrics_match_jax(run):
  jmet, tmet = run["jmet"], run["tmet"]
  assert sorted(tmet) == sorted(jmet)
  assert len([k for k in tmet if k.startswith("Metrics/motion/")]) == 13
  for k, v in jmet.items():
    tp.assert_close(tmet[k].numpy().astype(np.float64), np.asarray(v, np.float64), TOL, k)


def test_env_and_command_state_match_jax(run):
  jst = run["jstate"].env_state
  env = run["tr"].env
  for f in ("qpos", "qvel"):
    tp.assert_close(getattr(env.data, f).numpy(), np.asarray(getattr(jst.data, f)), TOL, f)
  jcmd, cmd = jst.ms["command"]["motion"], env.command_manager.get_term("motion").state
  np.testing.assert_array_equal(cmd["time_steps"].numpy(), np.asarray(jcmd["time_steps"]))
  for k in ("body_pos_relative_w", "body_quat_relative_w"):
    tp.assert_close(cmd[k].numpy(), np.asarray(jcmd[k]), TOL, k)
