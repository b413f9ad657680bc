"""One PPO training iteration of the PyTorch port's OnPolicyRunner against
the JAX package's, on the G1 velocity-flat task (float64 env, CPU) in its
certain-draw variant: 4 envs, 0.3 s episodes (15 env steps) and a rollout
of T = 16, so that every env resets inside the rollout; 2 epochs × 2
minibatches; the real hidden widths 512/256/128.

Both runners start from one state: the JAX runner's env state, observations
and learner (params, Adam state, lr, with normalizers of nonzero count),
carried in float64, and take the same draws: JAX's rollout noise and
epoch permutations, rebuilt from its keys as runner.py:192-193,161 and
ppo.py:208-209 draw them.

Tolerance 1e-6 relative to max(1, max |JAX|): both runners cast the
observations to float32 before the normalizers (runner.py:157-158,440)
and the rewards when stored, so two float64 observations that differ in
the last bits can round to float32 values one float32 ulp apart, which
the rollout then carries. The learner itself agrees to 1e-10
(tests/test_torch_ppo.py)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu.tasks.velocity.config.g1.rl_cfg import UnitreeG1PPORunnerCfg
from mjlab_tpu_torch.rl import ppo as tppo
from mjlab_tpu_torch.rl.networks import RunningNorm
from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
from mjlab_tpu_torch.tasks import load_rl_cfg

NUM_ENVS = 4
T = 16
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
def run():
  """Both runners after one iteration from one state, with their rollouts,
  advantages and metrics."""
  jenv, env = tp.g1_flat_envs(NUM_ENVS, tp.certain_variant)
  return tp.iteration_pair(
    jenv, env, _rl_cfg(UnitreeG1PPORunnerCfg()),
    _rl_cfg(load_rl_cfg("Mjlab-Velocity-Flat-Unitree-G1")), T,
  )


def test_rollout_matches_jax(run):
  jb, tb = run["jbatch"], run["tbatch"]
  done = np.asarray(jb.done)
  assert done.any(axis=0).all(), "every env resets inside the rollout"
  np.testing.assert_array_equal(tb.done.numpy(), done)
  for f in dataclasses.fields(tppo.Transition):
    if f.name != "done":
      tp.assert_close(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)), TOL, f.name)


def test_advantages_and_returns_match_jax(run):
  for what, (j, t) in (("advantages", run["adv"]), ("returns", run["ret"])):
    tp.assert_close(t.numpy(), j, TOL, what)


def test_learner_state_matches_jax(run):
  """params, Adam state, normalizers and lr after the update."""
  want = tp.jax_runner_arrays(run["jstate"])
  got = runner_state_to_arrays(run["tr"])
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    tp.assert_close(got[k].astype(np.float64), v.astype(np.float64), TOL, k)
  assert int(got["opt/count"]) == 4


def test_metrics_match_jax(run):
  jmet, tmet = run["jmet"], run["tmet"]
  assert sorted(tmet) == sorted(jmet)
  for k, v in jmet.items():
    tp.assert_close(tmet[k].numpy().astype(np.float64), np.asarray(v, np.float64), TOL, k)
  assert float(jmet["Train/resets"]) >= NUM_ENVS


def test_env_state_matches_jax(run):
  jd, td = run["jstate"].env_state.data, run["tr"].env.data
  for f in ("qpos", "qvel"):
    tp.assert_close(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), TOL, f)


def test_normalizers_update_with_normalized_observations(run):
  """Both packages update the normalizers with the stored observations,
  which are already normalized (runner.py:157,171,449-452), not with the
  raw ones as rsl_rl does: a fault of the reference that the port mirrors.
  The raw observations are recovered from the stored ones."""
  for pkg, batch, new in (
    ("jax", run["jbatch"], run["jstate"]),
    ("port", run["tbatch"], run["tr"]),
  ):
    for group, field in (("actor", "actor_obs"), ("critic", "critic_obs")):
      o = run["old"][group]
      old = RunningNorm(**{f: torch.as_tensor(np.asarray(getattr(o, f)))
                           for f in ("mean", "var", "count")})
      stored = torch.as_tensor(np.asarray(getattr(batch, field)))
      raw = stored * torch.sqrt(old.var + 1e-8) + old.mean
      got = getattr(new, f"{group}_norm")
      got_mean = np.asarray(got.mean.cpu() if isinstance(got.mean, torch.Tensor) else got.mean)
      from_stored, from_raw = old.update(stored), old.update(raw)
      tp.assert_close(got_mean, from_stored.mean.numpy(), 1e-10, f"{pkg} {group} mean")
      gap = np.abs(from_raw.mean.numpy() - got_mean).max()
      assert gap > 0.1, f"{pkg} {group}: the raw-obs update would differ by {gap}"


def test_robot_metadata_matches_jax(run):
  from mjlab_tpu.rl.exporter import collect_robot_metadata as jax_metadata
  from mjlab_tpu_torch.rl.exporter import collect_robot_metadata

  want = jax_metadata(run["jenv"])
  got = collect_robot_metadata(run["tr"].env)
  assert sorted(got) == sorted(want)
  for k, v in want.items():
    if isinstance(v, list) and v and isinstance(v[0], float):
      np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    else:
      assert got[k] == v, k


def test_torchscript_policy_matches_inference_policy(run, tmp_path):
  from mjlab_tpu_torch.rl.exporter import export_policy_as_torchscript

  tr = run["tr"]
  path = export_policy_as_torchscript(tr, tr.env, str(tmp_path / "policy.pt"))
  extra = {"metadata.json": ""}
  scripted = torch.jit.load(path, _extra_files=extra)
  obs = tr.obs["policy"]
  want = tr.get_inference_policy()(tr.obs)
  with torch.no_grad():
    got = scripted(obs.to(torch.float32))
  # The export is float32; the learner here is float64.
  tp.assert_close(got.numpy(), want.numpy(), 1e-5, "exported action")
  meta = json.loads(extra["metadata.json"])
  assert meta["joint_names"] == list(tr.env.scene["robot"].joint_names)


def test_vecenv_wrapper_clips_actions_and_reports_time_outs():
  """The rsl_rl-style wrapper: actions clipped before the env sees them,
  dones = terminated | time_outs, extras["time_outs"] for bootstrapping."""
  from mjlab_tpu_torch.rl.vecenv_wrapper import RlVecEnvWrapper
  from mjlab_tpu_torch.tasks import make_env

  env = make_env("Mjlab-Velocity-Flat-Unitree-G1", num_envs=2, device="cpu",
                 episode_length_s=0.04)  # 2 env steps
  wrapped = RlVecEnvWrapper(env, clip_actions=0.5)
  assert wrapped.num_actions == 29 and wrapped.max_episode_length == 2
  action = torch.full((2, 29), 3.0)
  obs, rew, dones, extras = wrapped.step(action)
  raw = env.action_manager.get_term("joint_pos").state["raw"]
  assert torch.equal(raw, torch.full_like(raw, 0.5))
  assert obs["policy"].shape == (2, 99) and rew.shape == (2,)
  assert not dones.any() and not extras["time_outs"].any()
  obs, rew, dones, extras = wrapped.step(action)
  assert extras["time_outs"].all() and torch.equal(dones, extras["time_outs"])


@pytest.mark.parametrize("finite_horizon", [False, True])
def test_runner_steps_through_the_wrapper(finite_horizon):
  """The runner's env sees the wrapper's clipped actions while the rollout
  keeps the sampled ones, and GAE's time-outs are the wrapper's: every env
  times out at the second of its 2-step episodes. A finite-horizon task
  reports them all the same, because the env puts them in its extras
  before the wrapper could leave them out, as the JAX package's env does
  (mjlab_tpu/envs/manager_based_rl_env.py:255): a fault of the reference
  that the port mirrors."""
  from mjlab_tpu_torch.scripts.train import build_runner

  runner = build_runner("Mjlab-Velocity-Flat-Unitree-G1", {
    "env.scene.num_envs": "2",
    "env.episode_length_s": "0.04",
    "env.is_finite_horizon": str(finite_horizon),
    "agent.num_steps_per_env": "2",
    "agent.clip_actions": "0.5",
    "agent.policy.actor_hidden_dims": "(16,)",
    "agent.policy.critic_hidden_dims": "(16,)",
  }, device="cpu")
  noise = torch.full((2, runner.num_actions), 10.0)
  first, _ = runner.rollout_step(noise)
  raw = runner.env.action_manager.get_term("joint_pos").state["raw"]
  assert torch.equal(raw, torch.full_like(raw, 0.5)) and (first.action > 0.5).all()
  assert not first.done.any() and not first.time_out.any()
  second, _ = runner.rollout_step(noise)
  assert second.done.all()
  assert torch.equal(second.time_out, torch.ones(2))
