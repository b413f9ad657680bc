"""The port's training entry point, `python -m mjlab_tpu_torch.scripts.train`,
on the CPU at a tiny size (2 envs, T = 2, 1 iteration, hidden 32/32): it
writes the checkpoint, the TorchScript policy, metrics.jsonl and
final_metrics.json; the checkpoint loads back into a runner built as the
script builds it. `--profile`, `--enable_nan_guard` and `--registry-name`
are ported; the JAX script's video flags raise NotImplementedError
(`--motion-file` raises ValueError on a task without a motion command, and
`--mesh 2` in a process of its own, where the world size is 1; the
sharded runs: tests/test_torch_distributed.py), and without a device the
runner asks for CUDA.
tests/test_torch_tracking_train.py trains a tracking task through
`--motion-file`; tests/test_torch_run_lifecycle.py holds periodic saves and
`--agent.resume`."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TASK = "Mjlab-Velocity-Flat-Unitree-G1"
TINY = {
  "env.scene.num_envs": "2",
  "agent.num_steps_per_env": "2",
  "agent.max_iterations": "1",
  "agent.policy.actor_hidden_dims": "(32, 32)",
  "agent.policy.critic_hidden_dims": "(32, 32)",
  "agent.algorithm.num_learning_epochs": "1",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """A few-env CPU step is thousands of tiny ops, faster on one thread."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  log_dir = tmp_path_factory.mktemp("train")
  args = [a for k, v in TINY.items() for a in (f"--{k}", v)]
  env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
  out = subprocess.run(
    [sys.executable, "-m", "mjlab_tpu_torch.scripts.train", TASK, *args,
     "--log_dir", str(log_dir)],
    cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
  )
  assert out.returncode == 0, out.stderr[-3000:]
  return log_dir, out.stdout


def test_train_writes_checkpoint_policy_and_metrics(trained):
  log_dir, stdout = trained
  assert "[runner] 1 iterations" in stdout
  final = json.loads((log_dir / "final_metrics.json").read_text())
  assert final["iteration"] == 1
  for k in ("Loss/loss", "Loss/kl", "Loss/value_loss", "Loss/lr", "Train/mean_step_reward"):
    assert math.isfinite(final[k]), k
  assert 1e-5 <= final["Loss/lr"] <= 1e-2
  lines = (log_dir / "metrics.jsonl").read_text().splitlines()
  assert [json.loads(line)["iteration"] for line in lines] == [0]
  policy = torch.jit.load(str(log_dir / "model_1_policy.pt"))
  act = policy(torch.zeros(3, 99))
  assert act.shape == (3, 29) and torch.isfinite(act).all()


def test_checkpoint_loads_into_a_fresh_runner(trained):
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import build_runner

  log_dir, _ = trained
  saved = torch.load(log_dir / "model_1.pt")
  runner = build_runner(TASK, TINY)
  before = runner_state_to_arrays(runner)
  runner.load(str(log_dir / "model_1.pt"))
  after = runner_state_to_arrays(runner)
  assert runner.iteration == 1 and sorted(after) == sorted(saved["state"])
  for k, v in saved["state"].items():
    np.testing.assert_array_equal(after[k], v.numpy(), err_msg=k)
  assert not np.array_equal(after["params/actor/Dense_0/kernel"],
                            before["params/actor/Dense_0/kernel"])


@pytest.mark.parametrize("flag", ["mesh", "video", "video_interval", "motion-file"])
def test_unported_flags_raise(flag):
  from mjlab_tpu_torch.scripts.train import run_train

  error = ValueError if flag in ("motion-file", "mesh") else NotImplementedError
  with pytest.raises(error, match=f"--{flag}"):
    run_train(TASK, {**TINY, flag: "2" if flag == "mesh" else "1"})


def test_unknown_flags_raise():
  from mjlab_tpu_torch.scripts.train import build_runner

  with pytest.raises(ValueError, match="--num_envs"):
    build_runner(TASK, {**TINY, "num_envs": "4"})


@pytest.mark.parametrize("flag", ["profile", "enable_nan_guard", "registry-name"])
def test_ported_flags_train(flag, tmp_path, monkeypatch):
  """The flags the port once refused: `--profile 1` writes a Chrome trace
  of the first iteration under <log_dir>/profile and trains the rest;
  `--enable_nan_guard` trains through healthy iterations without a dump;
  `--registry-name` takes the tracking task's motion from the local
  registry."""
  from mjlab_tpu_torch.scripts.train import run_train

  over = {**TINY, "agent.max_iterations": "2", "log_dir": str(tmp_path)}
  task = TASK
  if flag == "profile":
    over.update({"agent.num_steps_per_env": "1", flag: "1"})
  elif flag == "enable_nan_guard":
    over[flag] = "true"
  else:
    from mjlab_tpu_torch.tasks.tracking.motions import make_standing_motion
    from mjlab_tpu_torch.utils.artifacts import LocalRegistry

    monkeypatch.setenv("MJLAB_REGISTRY_DIR", str(tmp_path / "registry"))
    motion = make_standing_motion(str(tmp_path / "motion.npz"), device="cpu")
    over[flag] = "motions/stand"
    task = "Mjlab-Tracking-Flat-Unitree-G1"
    dst = LocalRegistry().publish(motion, "motions/stand")
  runner = run_train(task, over)
  assert runner.iteration == 2 and (tmp_path / "model_2.pt").is_file()
  lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
  assert [json.loads(line)["iteration"] for line in lines] == [0, 1]
  if flag == "profile":
    traces = list((tmp_path / "profile").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(traces[0].read_text())
  elif flag == "enable_nan_guard":
    assert not (tmp_path / "nan_dumps").exists()
  else:
    assert runner.env.cfg.commands["motion"].motion_file == str(dst / "motion.npz")


def test_save_interval_is_read(tmp_path):
  from mjlab_tpu_torch.scripts.train import run_train

  run_train(TASK, {**TINY, "agent.max_iterations": "3", "agent.save_interval": "2",
                   "log_dir": str(tmp_path)})
  assert sorted(p.name for p in tmp_path.glob("model_?.pt")) == [
    "model_0.pt", "model_2.pt", "model_3.pt"]


def test_runner_asks_for_cuda_by_default():
  """Without a device the runner cfg's default, CUDA, is used; where there
  is none it raises and never falls back to the CPU."""
  from mjlab_tpu_torch.scripts.train import build_runner

  overrides = {k: v for k, v in TINY.items() if k != "agent.device"}
  if torch.cuda.is_available():
    assert build_runner(TASK, overrides).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    build_runner(TASK, overrides)


def test_g1_rl_cfg_matches_jax():
  """The G1 PPO cfg is the JAX package's, but for the device, the TPU
  relay's rollout modes and the fields that nothing in the port reads,
  which the port does not have."""
  from mjlab_tpu.tasks.velocity.config.g1.rl_cfg import UnitreeG1PPORunnerCfg
  from mjlab_tpu_torch.tasks import load_rl_cfg

  want = dataclasses.asdict(UnitreeG1PPORunnerCfg())
  got = dataclasses.asdict(load_rl_cfg(TASK))
  assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
  for k in ("fused_rollout", "rollout_chunk", "epoch_chunk", "packed_hostloop",
            "empirical_normalization", "run_name", "logger",
            "wandb_project", "load_run", "load_checkpoint"):
    want.pop(k)
  for group in ("policy", "algorithm"):
    want[group].pop("class_name")
  assert got == want
  assert got["save_interval"] == 50


@pytest.mark.parametrize("field", ["logger", "empirical_normalization", "run_name",
                                   "wandb_project", "load_run", "load_checkpoint"])
def test_unread_cfg_fields_are_rejected(field):
  """Fields that nothing in the port reads are not in its cfg, so setting
  one fails instead of doing nothing."""
  from mjlab_tpu_torch.scripts.train import build_runner

  with pytest.raises(AttributeError, match=field):
    build_runner(TASK, {**TINY, f"agent.{field}": "1"})
