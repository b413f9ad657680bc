"""Training Go1 on flat ground through the port's entry points on the CPU
at a tiny size: `python -m mjlab_tpu_torch.scripts.train
Mjlab-Velocity-Flat-Unitree-Go1 --env.scene.num_envs 2
--agent.num_steps_per_env 2 --agent.max_iterations 1 --agent.device cpu`
(the task's own PPO cfg); `play` and `joint_deltas` on the checkpoint; the
PPO cfg equals the JAX package's; without a device the runner asks for
CUDA."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

import torch_parity as tp

TASK = "Mjlab-Velocity-Flat-Unitree-Go1"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  log_dir = tmp_path_factory.mktemp("train")
  return log_dir, tp.train_cli(TASK, log_dir)


def test_train_cli_runs_one_iteration(trained):
  log_dir, stdout = trained
  tp.check_trained(log_dir, stdout, 48, 12)


def test_play_and_joint_deltas_take_the_checkpoint(trained):
  from mjlab_tpu_torch.scripts.joint_deltas import run_joint_deltas
  from mjlab_tpu_torch.scripts.play import run_play

  log_dir, _ = trained
  flags = {"agent.device": "cpu", "checkpoint": str(log_dir / "model_1.pt"),
           "num_envs": "2", "steps": "2"}
  res = run_play(TASK, flags)
  assert res.base_z.shape == (2,) and math.isfinite(res.mean_reward)
  table = run_joint_deltas(TASK, flags).splitlines()
  assert len(table) == 4 + 12 + 1, table


def test_rl_cfg_matches_jax():
  """The PPO cfg is the JAX package's, but for the device and the fields
  the port does not have (as for G1)."""
  from mjlab_tpu.tasks.velocity.config.go1.rl_cfg import UnitreeGo1PPORunnerCfg
  from mjlab_tpu_torch.tasks import load_rl_cfg

  want = dataclasses.asdict(UnitreeGo1PPORunnerCfg())
  got = dataclasses.asdict(load_rl_cfg(TASK))
  assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
  for k in ("fused_rollout", "rollout_chunk", "epoch_chunk", "packed_hostloop",
            "empirical_normalization", "run_name", "logger",
            "wandb_project", "load_run", "load_checkpoint"):
    want.pop(k)
  for group in ("policy", "algorithm"):
    want[group].pop("class_name")
  assert got == want
  assert got["policy"]["actor_obs_normalization"] is False


def test_runner_asks_for_cuda_by_default():
  from mjlab_tpu_torch.scripts.train import build_runner

  overrides = {k: v for k, v in tp.TINY_CLI.items() if k != "agent.device"}
  if torch.cuda.is_available():
    assert build_runner(TASK, overrides).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    build_runner(TASK, overrides)
