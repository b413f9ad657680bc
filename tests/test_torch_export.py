"""Policy export in the port against the JAX package's: `export_policy_as_onnx`
returns None in both where the ONNX stack is not installed; both packages'
`TorchScriptPolicy` read one exported file to the same actions and
metadata, and the JAX exporter, fed the port's learner by the JAX
RunnerState's names, writes a policy that acts the same; `OnnxPolicy`
raises ImportError in both without onnxruntime."""

from __future__ import annotations

import importlib.util
import types

import numpy as np
import pytest
import torch

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
TINY = {
  "env.scene.num_envs": "2",
  "agent.num_steps_per_env": "2",
  "agent.policy.actor_hidden_dims": "(32, 16)",
  "agent.policy.critic_hidden_dims": "(32, 16)",
  "agent.algorithm.num_learning_epochs": "1",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}
NO_ONNX = importlib.util.find_spec("onnx") is None
NO_ORT = importlib.util.find_spec("onnxruntime") is None


@pytest.fixture(scope="module")
def runner():
  from mjlab_tpu_torch.scripts.train import build_runner

  n = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    r = build_runner(TASK, TINY)
    r.train_iteration()  # moves the params and the normalizer off their start
  finally:
    torch.set_num_threads(n)
  return r


def _jax_stand_in(runner):
  """What the JAX exporter reads of a JAX runner, from the port's learner
  by the JAX RunnerState's names."""
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays

  arrays = runner_state_to_arrays(runner)
  actor = {}
  for k, v in arrays.items():
    if k.startswith("params/actor/"):
      layer, leaf = k.split("/")[2:]
      actor.setdefault(layer, {})[leaf] = v
  state = types.SimpleNamespace(
    train=types.SimpleNamespace(params={"params": {"actor": actor}}),
    actor_norm=types.SimpleNamespace(mean=arrays["actor_norm/mean"],
                                     var=arrays["actor_norm/var"]),
  )
  return types.SimpleNamespace(state=state, ac=types.SimpleNamespace(activation="elu"),
                               num_actor_obs=runner.num_actor_obs)


def test_onnx_export_returns_none_in_both_without_onnx(runner, tmp_path):
  from mjlab_tpu.rl.exporter import export_policy_as_onnx as jax_export
  from mjlab_tpu_torch.rl.exporter import collect_robot_metadata, export_policy_as_onnx

  meta = collect_robot_metadata(runner.env)
  got = export_policy_as_onnx(runner, runner.env, str(tmp_path / "p.onnx"))
  want = jax_export(_jax_stand_in(runner), None, str(tmp_path / "j.onnx"), metadata=meta)
  if NO_ONNX:
    assert got is None and want is None
  else:
    assert got == str(tmp_path / "p.onnx") and want == str(tmp_path / "j.onnx")


def test_torchscript_policies_agree(runner, tmp_path):
  from mjlab_tpu.rl.exporter import export_policy_as_torchscript as jax_export
  from mjlab_tpu.rl.onnx_policy import TorchScriptPolicy as JaxPolicy
  from mjlab_tpu_torch.rl.exporter import collect_robot_metadata, export_policy_as_torchscript
  from mjlab_tpu_torch.rl.onnx_policy import TorchScriptPolicy

  path = export_policy_as_torchscript(runner, runner.env, str(tmp_path / "model_1_policy.pt"))
  obs = np.random.default_rng(0).normal(size=(5, runner.num_actor_obs)).astype(np.float32)
  ours, theirs = TorchScriptPolicy(path), JaxPolicy(path)
  np.testing.assert_array_equal(ours(obs), theirs(obs))
  assert ours.metadata == theirs.metadata == collect_robot_metadata(runner.env)
  assert len(ours.metadata["joint_names"]) == 29
  want = runner.get_inference_policy()({"policy": torch.from_numpy(obs)}).numpy()
  np.testing.assert_allclose(ours(obs), want, rtol=1e-6, atol=1e-6)

  jpath = jax_export(_jax_stand_in(runner), None, str(tmp_path / "jax_policy.pt"),
                     metadata=ours.metadata)
  jax_made = TorchScriptPolicy(jpath)
  np.testing.assert_allclose(jax_made(obs), ours(obs), rtol=1e-6, atol=1e-6)
  assert jax_made.metadata == ours.metadata


def test_onnx_policy_needs_onnxruntime_in_both(tmp_path):
  from mjlab_tpu.rl.onnx_policy import OnnxPolicy as JaxOnnxPolicy
  from mjlab_tpu_torch.rl.onnx_policy import OnnxPolicy

  for cls in (OnnxPolicy, JaxOnnxPolicy):
    # With onnxruntime, the session fails on the missing file instead.
    with pytest.raises(ImportError if NO_ORT else Exception,
                       match="onnxruntime is required" if NO_ORT else None):
      cls(str(tmp_path / "p.onnx"))
