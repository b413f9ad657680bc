"""Training the Asimov tasks through the port's entry points on the CPU at a
tiny size: `python -m mjlab_tpu_torch.scripts.train <task> --env.scene.num_envs 2
--agent.num_steps_per_env 2 --agent.max_iterations 1 --agent.device cpu`
for Mjlab-Velocity-Flat-Asimov and -Asimov-Toe (the task's own PPO cfg,
hidden 512/256/128); `play` and `joint_deltas` on the checkpoint; the PPO
cfgs equal the JAX package's; without a device the runner asks for CUDA;
and `list_envs` lists the port's 10 tasks."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import torch_parity as tp

TASKS = {"Mjlab-Velocity-Flat-Asimov": (48, "asimov"),
         "Mjlab-Velocity-Flat-Asimov-Toe": (45, "asimov_toe")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(TASKS))
def trained(request, tmp_path_factory):
  task = request.param
  log_dir = tmp_path_factory.mktemp("train")
  return task, log_dir, tp.train_cli(task, log_dir)


def test_train_cli_runs_one_iteration(trained):
  task, log_dir, stdout = trained
  tp.check_trained(log_dir, stdout, TASKS[task][0], 12)


def test_play_and_joint_deltas_take_the_checkpoint(trained):
  from mjlab_tpu_torch.scripts.joint_deltas import run_joint_deltas
  from mjlab_tpu_torch.scripts.play import run_play

  task, log_dir, _ = trained
  flags = {"agent.device": "cpu", "checkpoint": str(log_dir / "model_1.pt"),
           "num_envs": "2", "steps": "2"}
  run_play(task, flags)
  table = run_joint_deltas(task, flags).splitlines()
  # One row per actuated joint the actions drive: 12 leg joints, or the
  # 8 hip and knee joints of the toe variant (its ankles go through tendons).
  assert len(table) == 4 + (8 if task.endswith("Toe") else 12) + 1, table


@pytest.mark.parametrize("task", sorted(TASKS))
def test_rl_cfg_matches_jax(task):
  """The task's PPO cfg is the JAX package's, but for the device and the
  fields the port does not have (as for G1)."""
  import importlib

  from mjlab_tpu_torch.tasks import load_rl_cfg

  jax_cfg = importlib.import_module(
    f"mjlab_tpu.tasks.velocity.config.{TASKS[task][1]}.rl_cfg").AsimovPPORunnerCfg
  want = dataclasses.asdict(jax_cfg())
  got = dataclasses.asdict(load_rl_cfg(task))
  assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
  for k in ("fused_rollout", "rollout_chunk", "epoch_chunk", "packed_hostloop",
            "empirical_normalization", "run_name", "logger",
            "wandb_project", "load_run", "load_checkpoint"):
    want.pop(k)
  for group in ("policy", "algorithm"):
    want[group].pop("class_name")
  assert got == want
  assert got["policy"]["actor_hidden_dims"] == (512, 256, 128)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_runner_asks_for_cuda_by_default(task):
  from mjlab_tpu_torch.scripts.train import build_runner

  overrides = {k: v for k, v in tp.TINY_CLI.items() if k != "agent.device"}
  if torch.cuda.is_available():
    assert build_runner(task, overrides).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    build_runner(task, overrides)


def test_list_envs_lists_five_tasks(capsys):
  from mjlab_tpu_torch.scripts import list_envs

  list_envs.main()
  rows = [line.split()[0] for line in capsys.readouterr().out.splitlines()[2:]]
  assert len(rows) == 10 and set(TASKS) <= set(rows)
