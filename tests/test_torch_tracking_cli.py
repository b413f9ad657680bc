"""The port's training entry point on the tracking task, on the CPU at a
tiny size: `python -m mjlab_tpu_torch.scripts.train
Mjlab-Tracking-Flat-Unitree-G1 --motion-file <npz>` (2 envs, T = 2, 1
iteration, hidden 32/32) on a motion made by the port's csv_to_npz run as a
script; `--motion_file` works the same; `--registry-name` with a name the
local registry does not hold raises the JAX package's FileNotFoundError
(tests/test_torch_artifacts.py resolves a published one); without a motion
file the env raises the JAX package's ValueError; without a device the
runner asks for CUDA."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
TASK = "Mjlab-Tracking-Flat-Unitree-G1"
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


def _run(module, *args):
  env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
  out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-3000:]
  return out.stdout


@pytest.fixture(scope="module")
def motion(tmp_path_factory):
  d = tmp_path_factory.mktemp("motion")
  csv = tp.synthetic_motion_csv(d / "m.csv", n_frames=31)
  stdout = _run("mjlab_tpu_torch.scripts.csv_to_npz", csv, "--output", str(d / "m.npz"),
                "--device", "cpu")
  assert "Wrote" in stdout and "50 frames at 50.0 fps" in stdout
  return str(d / "m.npz")


@pytest.mark.parametrize("flag", ["--motion-file", "--motion_file"])
def test_train_tracking_with_a_motion_file(motion, tmp_path, flag):
  args = [a for k, v in TINY.items() for a in (f"--{k}", v)]
  stdout = _run("mjlab_tpu_torch.scripts.train", TASK, *args, flag, motion,
                "--log_dir", str(tmp_path))
  assert "[runner] 1 iterations" in stdout
  final = json.loads((tmp_path / "final_metrics.json").read_text())
  for k in ("Loss/loss", "Loss/kl", "Loss/value_loss", "Metrics/motion/error_anchor_pos"):
    assert math.isfinite(final[k]), k
  policy = torch.jit.load(str(tmp_path / "model_1_policy.pt"))
  act = policy(torch.zeros(3, 160))
  assert act.shape == (3, 29) and torch.isfinite(act).all()


def test_motion_file_reaches_the_command(motion):
  from mjlab_tpu_torch.scripts.train import build_runner

  runner = build_runner(TASK, {**TINY, "motion_file": motion})
  cmd = runner.env.command_manager.get_term("motion")
  assert runner.env.cfg.commands["motion"].motion_file == motion
  assert cmd.motion.time_step_total == 50 and cmd.bin_count == 2
  np.testing.assert_array_equal(cmd.motion.joint_pos.numpy(),
                                np.load(motion)["joint_pos"].astype(np.float32))


def test_registry_name_raises(tmp_path, monkeypatch):
  from mjlab_tpu.utils.artifacts import resolve_motion_file
  from mjlab_tpu_torch.scripts.train import build_runner

  monkeypatch.setenv("MJLAB_REGISTRY_DIR", str(tmp_path))
  with pytest.raises(FileNotFoundError, match="'org/motions/walk' not found") as want:
    resolve_motion_file("org/motions/walk")
  with pytest.raises(type(want.value), match="'org/motions/walk' not found in local registry"):
    build_runner(TASK, {**TINY, "registry-name": "org/motions/walk"})


def test_no_motion_file_raises_the_jax_error():
  from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
  from mjlab_tpu_torch.scripts.train import build_runner

  jcfg, _ = tp.g1_tracking_cfgs(2, "")
  with pytest.raises(ValueError, match="motion_file is empty") as want:
    JaxEnv(jcfg)
  with pytest.raises(type(want.value), match="MotionCommandCfg.motion_file is empty"):
    build_runner(TASK, TINY)


def test_runner_asks_for_cuda_by_default(motion):
  from mjlab_tpu_torch.scripts.train import build_runner

  overrides = {k: v for k, v in TINY.items() if k != "agent.device"}
  if torch.cuda.is_available():
    assert build_runner(TASK, {**overrides, "motion_file": motion}).device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    build_runner(TASK, {**overrides, "motion_file": motion})
