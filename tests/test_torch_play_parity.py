"""The port's `run_play --policy trained` against the JAX package's, on one
learner, on the G1 velocity-flat task (float64 env, CPU, 2 envs, 4 steps,
32-wide hidden layers).

Both scripts build their own env and runner. The JAX one's `load` is
replaced by setting one float64 learner (its initial params, normalizers of
nonzero count); the port loads the same arrays from a checkpoint in its own
format. The port's env takes the JAX env's state and observations after the
play's reset in place of its own draws; the play overrides leave no draw
after that (no pushes, no corruption, an endless episode). Then both roll
out: the env calls and the policy calls come in the same order, and every
step's actions and rewards, the mean reward per step, the final base
heights and the printed summary line agree.

Tolerance 1e-6 relative to max(1, max |JAX|), as for the runner's rollout
(tests/test_torch_runner.py): both policies cast the observations to
float32 before the normalizer."""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_parity as tp

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
NUM_ENVS = 2
STEPS = 4
TOL = 1e-6
COMMON = {
  "num_envs": str(NUM_ENVS),
  "steps": str(STEPS),
  "seed": "3",
  "env.sim.dtype": "float64",
  "agent.policy.actor_hidden_dims": "(32, 32)",
  "agent.policy.critic_hidden_dims": "(32, 32)",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
  with tp.torch_threads(1):
    yield


def _recording_policy(policy, log: list, actions: list):
  def wrapped(obs):
    log.append("policy")
    a = policy(obs)
    actions.append(tp.numpy_tree(a).copy())
    return a

  return wrapped


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
  """Both packages' play of one learner from one reset state: their call
  logs, per-step actions and rewards, final base z and summary lines."""
  import gymnasium
  import jax.numpy as jnp

  import mjlab_tpu_torch.envs as tenvs
  from mjlab_tpu.rl.networks import RunningNorm as JaxRunningNorm
  from mjlab_tpu.rl.runner import OnPolicyRunner as JaxRunner
  from mjlab_tpu.scripts.play import run_play as jax_run_play
  from mjlab_tpu_torch.envs import env_state_from_arrays
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.play import run_play

  out = {p: {"calls": [], "actions": [], "rewards": []} for p in ("jax", "torch")}
  held: dict = {}
  real_make = gymnasium.make

  def make(task, cfg=None):
    wrapped = real_make(task, cfg=cfg)
    jenv = wrapped.unwrapped
    real_reset, real_step = jenv.reset, jenv.step

    def reset(seed=None, **kwargs):
      out["jax"]["calls"].append("reset")
      obs, extras = real_reset(seed=seed, **kwargs)
      held["reset"] = (tp.jax_env_arrays(jenv), tp.numpy_tree(obs))
      return obs, extras

    def step(action):
      out["jax"]["calls"].append("step")
      res = real_step(action)
      out["jax"]["rewards"].append(np.asarray(res[1]))
      return res

    jenv.reset, jenv.step = reset, step
    held["jenv"] = jenv
    return wrapped

  rng = np.random.default_rng(0)

  def norm(dim):
    return JaxRunningNorm(mean=jnp.asarray(rng.normal(0, 0.5, dim)),
                          var=jnp.asarray(rng.uniform(0.5, 2.0, dim)),
                          count=jnp.asarray(200.0))

  def jax_load(self, path):
    out["jax"]["calls"].append("load")
    self.state = tp.jax_learner_f64(self.state).replace(
      actor_norm=norm(self.num_actor_obs), critic_norm=norm(self.num_critic_obs))
    held["learner"] = tp.jax_runner_arrays(self.state)

  def jax_policy(self):
    return _recording_policy(real_jax_policy(self), out["jax"]["calls"], out["jax"]["actions"])

  class RecordingEnv(tenvs.ManagerBasedRlEnv):
    def reset(self, seed=None, options=None):
      out["torch"]["calls"].append("reset")
      _, extras = super().reset(seed=seed, options=options)
      arrays, obs = held["reset"]
      env_state_from_arrays(self, arrays)
      return {k: torch.as_tensor(v) for k, v in obs.items()}, extras

    def step(self, action):
      out["torch"]["calls"].append("step")
      res = super().step(action)
      out["torch"]["rewards"].append(res[1].numpy().copy())
      return res

  real_load = OnPolicyRunner.load
  real_jax_policy, real_policy = JaxRunner.get_inference_policy, OnPolicyRunner.get_inference_policy

  def load(self, path):
    out["torch"]["calls"].append("load")
    real_load(self, path)

  def policy(self):
    return _recording_policy(real_policy(self), out["torch"]["calls"], out["torch"]["actions"])

  ckpt = tmp_path_factory.mktemp("play") / "model_7.pt"
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(gymnasium, "make", make)
    mp.setattr(JaxRunner, "load", jax_load)
    mp.setattr(JaxRunner, "get_inference_policy", jax_policy)
    mp.setattr(tenvs, "ManagerBasedRlEnv", RecordingEnv)
    mp.setattr(OnPolicyRunner, "load", load)
    mp.setattr(OnPolicyRunner, "get_inference_policy", policy)
    jax_out, torch_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jax_out):
      jax_run_play(TASK, {**COMMON, "checkpoint": "unused"})
    # The learner JAX played, as a checkpoint in the port's format.
    torch.save({"state": {k: torch.from_numpy(np.array(v)) for k, v in held["learner"].items()},
                "iteration": 7}, ckpt)
    with contextlib.redirect_stdout(torch_out):
      res = run_play(TASK, {**COMMON, "checkpoint": str(ckpt), "agent.device": "cpu"})
  out["jax"]["base_z"] = np.asarray(held["jenv"].state.data.qpos[:, 2])
  out["jax"]["line"] = jax_out.getvalue().strip().splitlines()[-1]
  out["jax"]["mean_reward"] = np.sum(out["jax"]["rewards"], axis=0).mean() / STEPS
  out["torch"]["base_z"] = res.base_z
  out["torch"]["line"] = torch_out.getvalue().strip().splitlines()[-1]
  out["torch"]["mean_reward"] = res.mean_reward
  return out


def test_play_calls_come_in_the_jax_order(plays):
  want = plays["jax"]["calls"]
  assert want == ["reset", "load", "reset"] + ["policy", "step"] * STEPS
  assert plays["torch"]["calls"] == want


def test_play_actions_and_rewards_match_jax(plays):
  j, t = plays["jax"], plays["torch"]
  assert len(t["actions"]) == len(j["actions"]) == STEPS
  for i in range(STEPS):
    tp.assert_close(t["actions"][i], j["actions"][i], TOL, f"actions[{i}]")
    tp.assert_close(t["rewards"][i], j["rewards"][i], TOL, f"rewards[{i}]")
  assert np.abs(j["actions"][0]).max() > 0.05  # the trained policy acts


def test_play_summary_matches_jax(plays):
  j, t = plays["jax"], plays["torch"]
  tp.assert_close(np.float64(t["mean_reward"]), np.float64(j["mean_reward"]), TOL, "mean reward")
  tp.assert_close(t["base_z"], j["base_z"], TOL, "base z")
  assert t["line"] == j["line"]
