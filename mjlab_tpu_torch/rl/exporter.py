"""Deployable policy export with embedded robot metadata (port of
mjlab_tpu/rl/exporter.py).

The reference exports each checkpoint with deployment metadata (joint
names, stiffness and damping of the compiled model, default pose,
observation and command names, action scale; reference
tasks/velocity/rl/exporter.py:35-66). Here the policy is the runner's own
actor and actor normalizer, copied to the CPU in float32 and saved as
TorchScript with the metadata as an extra file. `export_policy_as_onnx`
is the JAX package's: `torch.onnx.export` and the metadata as ONNX
metadata_props, or None where the ONNX stack is not installed.
"""

from __future__ import annotations

import copy
import json
import os

import torch
from torch import nn


class NormalizedActor(nn.Module):
  """act = actor((obs - mean) / sqrt(var + 1e-8))."""

  def __init__(self, actor: nn.Module, mean: torch.Tensor, var: torch.Tensor):
    super().__init__()
    self.actor = actor
    self.register_buffer("mean", mean)
    self.register_buffer("var", var)

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    return self.actor((obs - self.mean) / torch.sqrt(self.var + 1e-8))


def build_torch_actor(runner) -> NormalizedActor:
  """The runner's actor and actor normalizer as one CPU float32 module."""
  cpu = dict(device="cpu", dtype=torch.float32)
  actor = copy.deepcopy(runner.ac.actor).to(**cpu)
  norm = runner.actor_norm
  return NormalizedActor(actor, norm.mean.detach().to(**cpu), norm.var.detach().to(**cpu)).eval()


def collect_robot_metadata(env, action_term_name: str = "joint_pos") -> dict:
  """Deployment metadata of the env's robot: per joint, the gains and
  damping of the actuator that drives it (0 for none; the compiled
  model's gainprm[0] and -biasprm[2], as the entity reads them) and the
  default position of the entity's init state."""
  robot = env.scene["robot"]
  data = robot.data
  gains = dict(zip(
    robot.actuator_names,
    zip(data.default_joint_stiffness[0].tolist(), data.default_joint_damping[0].tolist()),
  ))
  joint_names = list(robot.joint_names)
  term = env.action_manager.get_term(action_term_name)
  return {
    "joint_names": joint_names,
    "joint_stiffness": [gains.get(n, (0.0, 0.0))[0] for n in joint_names],
    "joint_damping": [gains.get(n, (0.0, 0.0))[1] for n in joint_names],
    "default_joint_pos": data.default_joint_pos[0].tolist(),
    "action_scale": term._scale.tolist(),
    "observation_names": list(env.observation_manager.active_terms.get("policy", [])),
    "command_names": list(env.command_manager.active_terms),
  }


def export_policy_as_torchscript(runner, env, path: str, metadata: dict | None = None) -> str:
  policy = build_torch_actor(runner)
  scripted = torch.jit.trace(policy, torch.zeros(1, runner.num_actor_obs))
  meta = metadata or collect_robot_metadata(env)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  torch.jit.save(scripted, path, _extra_files={"metadata.json": json.dumps(meta)})
  return path


def export_policy_as_onnx(runner, env, path: str, metadata: dict | None = None) -> str | None:
  """ONNX export with the metadata as metadata_props (each value JSON);
  returns None when the ONNX stack is unavailable in the environment."""
  policy = build_torch_actor(runner)
  example = torch.zeros(1, runner.num_actor_obs)
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  try:
    torch.onnx.export(policy, (example,), path, input_names=["obs"],
                      output_names=["action"], dynamo=False)
  except Exception as e:
    print(f"[exporter] ONNX export unavailable ({e}); TorchScript only.")
    return None
  try:
    import onnx

    model = onnx.load(path)
    meta = metadata or collect_robot_metadata(env)
    for key, value in meta.items():
      entry = model.metadata_props.add()
      entry.key = key
      entry.value = json.dumps(value)
    onnx.save(model, path)
  except ImportError:
    pass
  return path
