"""A training run's lifecycle in the port, on the CPU at a tiny size (2
envs, T = 2, 1 epoch, hidden 32/32): `learn` logs and checkpoints as it
goes at the JAX runner's iterations and labels, live logging changes
nothing against bare `train_iteration`s, `--agent.resume` picks up the
newest checkpoint, `resolve_checkpoint` picks what the JAX package's picks,
and a save that fails leaves the previous checkpoint whole."""

from __future__ import annotations

import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
TINY = {
  "env.scene.num_envs": "2",
  "agent.num_steps_per_env": "2",
  "agent.policy.actor_hidden_dims": "(32, 32)",
  "agent.policy.critic_hidden_dims": "(32, 32)",
  "agent.algorithm.num_learning_epochs": "1",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}
ITERS, SAVE_INTERVAL = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
  """run_train for ITERS iterations with save_interval SAVE_INTERVAL."""
  from mjlab_tpu_torch.scripts.train import run_train

  log_dir = tmp_path_factory.mktemp("run")
  run_train(TASK, {**TINY, "agent.max_iterations": str(ITERS),
                   "agent.save_interval": str(SAVE_INTERVAL), "log_dir": str(log_dir)})
  return log_dir


@pytest.fixture(scope="module")
def reference():
  """The same runner stepped by bare `train_iteration`s: the learner's
  arrays after each and each iteration's metrics as host floats."""
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import build_runner

  runner = build_runner(TASK, TINY)
  states, rows = [], []
  for _ in range(ITERS):
    m = runner.train_iteration()
    rows.append({k: float(v.to(torch.float64)) for k, v in m.items()})
    states.append(runner_state_to_arrays(runner))
  return states, rows


def _jax_save_labels(num_iterations: int, save_interval: int, start: int = 0) -> list[str]:
  """The labels the JAX runner's live `learn` saves under, from its own
  code, on a stand-in runner whose iteration does nothing."""
  from mjlab_tpu.rl.runner import OnPolicyRunner as JaxRunner

  saved = []
  state = types.SimpleNamespace(train=types.SimpleNamespace(params={}), env_state=None)
  fake = types.SimpleNamespace(
    cfg=types.SimpleNamespace(num_steps_per_env=2, save_interval=save_interval),
    env=types.SimpleNamespace(num_envs=2, _begin=lambda s: None),
    iteration=start, mesh=None, log_dir="logs", state=state,
    _train_iter=lambda s: (s, {"Train/mean_step_reward": 0.0,
                               "Train/mean_episode_length": 0.0,
                               "Loss/kl": 0.0, "Loss/lr": 0.0}),
    _log_metrics=lambda host, step=None: None,
    save=lambda path: saved.append(os.path.basename(path)),
  )
  JaxRunner.learn(fake, num_iterations, deferred_logging=False)
  return saved


def test_save_labels_are_the_jax_runners(run):
  labels = _jax_save_labels(ITERS, SAVE_INTERVAL)
  assert labels == ["model_0", "model_2", "model_4"]
  ckpts = sorted((p.name for p in run.glob("model_*.pt") if "policy" not in p.name),
                 key=lambda n: int(n[6:-3]))
  # learn's periodic saves, then run_train's final one after ITERS updates.
  assert ckpts == [f"{label}.pt" for label in labels] + [f"model_{ITERS}.pt"]
  for c in ckpts:
    assert (run / c.replace(".pt", "_policy.pt")).is_file()
    assert torch.load(run / c)["iteration"] == int(c[6:-3])
  assert not list(run.glob(".*.tmp"))
  lines = (run / "metrics.jsonl").read_text().splitlines()
  assert [json.loads(x)["iteration"] for x in lines] == list(range(ITERS))
  assert (run / "agent_cfg.yaml").is_file()


def test_checkpoint_holds_the_learner_after_its_update(run, reference):
  """model_k is the learner after k + 1 updates (label k, before the count
  advances)."""
  states, _ = reference
  for k in (0, 2, 4):
    saved = torch.load(run / f"model_{k}.pt")["state"]
    assert sorted(saved) == sorted(states[k])
    for name, v in saved.items():
      np.testing.assert_array_equal(v.numpy(), states[k][name], err_msg=f"model_{k} {name}")
  final = torch.load(run / f"model_{ITERS}.pt")["state"]
  for name, v in final.items():
    np.testing.assert_array_equal(v.numpy(), states[-1][name], err_msg=name)


def test_live_logging_changes_nothing(run, reference):
  """learn's rows (pulled every 10 iterations, written one line per
  iteration) equal the metrics of bare train_iterations with the same
  seed and draws, and the learner ends equal (previous test)."""
  _, rows = reference
  lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
  assert len(lines) == ITERS
  for it, (line, row) in enumerate(zip(lines, rows)):
    assert line.pop("iteration") == it
    assert line == row
  final = json.loads((run / "final_metrics.json").read_text())
  assert final.pop("iteration") == ITERS and final == rows[-1]


def test_resume_loads_the_newest_checkpoint_and_runs_its_label_again(tmp_path, monkeypatch,
                                                                     capsys):
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner, runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import run_train

  log = {**TINY, "log_dir": str(tmp_path)}
  run_train(TASK, {**log, "agent.max_iterations": "2"})
  assert sorted(p.name for p in tmp_path.glob("model_?.pt")) == ["model_0.pt", "model_2.pt"]
  loads = []
  load = OnPolicyRunner.load

  def recording_load(self, path):
    load(self, path)
    loads.append((path, runner_state_to_arrays(self), self.iteration))

  monkeypatch.setattr(OnPolicyRunner, "load", recording_load)
  capsys.readouterr()
  runner = run_train(TASK, {**log, "agent.max_iterations": "1", "agent.resume": "true"})
  assert f"resuming from {tmp_path / 'model_2.pt'}" in capsys.readouterr().out
  (path, state, it), = loads
  assert Path(path) == tmp_path / "model_2.pt" and it == 2
  saved = torch.load(path)["state"]
  assert sorted(state) == sorted(saved)
  for k, v in saved.items():
    np.testing.assert_array_equal(state[k], v.numpy(), err_msg=k)
  lines = [json.loads(x)["iteration"] for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
  assert lines == [0, 1, 2] and runner.iteration == 3
  assert (tmp_path / "model_3.pt").is_file()


def test_resume_without_a_checkpoint_starts_fresh(tmp_path, capsys):
  from mjlab_tpu_torch.scripts.train import run_train

  runner = run_train(TASK, {**TINY, "agent.max_iterations": "1", "agent.resume": "true",
                            "log_dir": str(tmp_path)})
  assert "no checkpoint" in capsys.readouterr().out
  assert runner.iteration == 1 and (tmp_path / "model_1.pt").is_file()


LAYOUTS = {
  "root": {"": [3, 12, 7]},
  "runs": {"2026-01-01_a": [5, 40], "2026-01-02_b": [1, 9], "notes": []},
  "root_before_runs": {"": [2], "2026-01-02_b": [50]},
  "newest_run_empty": {"2026-01-01_a": [4], "2026-01-03_c": []},
  "none": {"2026-01-01_a": []},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_resolve_checkpoint_matches_jax(tmp_path, layout):
  """The same tree for both packages (the JAX package's Orbax checkpoints
  are `model_<k>` directories, the port's `model_<k>.pt` files), each with
  the exported policies and, for the port, a save's temporary file as
  decoys: both pick the same iteration of the same run."""
  from mjlab_tpu.utils.os import resolve_checkpoint as jax_resolve
  from mjlab_tpu_torch.utils.os import resolve_checkpoint

  picks = {}
  for pkg in ("jax", "torch"):
    root = tmp_path / pkg
    for run, iters in LAYOUTS[layout].items():
      d = root / run
      d.mkdir(parents=True, exist_ok=True)
      for k in iters:
        if pkg == "jax":
          (d / f"model_{k}").mkdir()
        else:
          (d / f"model_{k}.pt").write_bytes(b"")
        (d / f"model_{k + 100}_policy.pt").write_bytes(b"")
      if pkg == "torch":
        (d / ".model_999.pt.tmp").write_bytes(b"")
        (d / "model_998.pt.tmp").write_bytes(b"")
    got = (jax_resolve if pkg == "jax" else resolve_checkpoint)(root)
    picks[pkg] = None if got is None else Path(got).relative_to(root).with_suffix("")
  assert picks["torch"] == picks["jax"]
  assert (picks["torch"] is None) == (layout == "none")


def test_failed_save_leaves_the_previous_checkpoint_whole(tmp_path, monkeypatch):
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays
  from mjlab_tpu_torch.scripts.train import build_runner

  runner = build_runner(TASK, TINY)
  path = tmp_path / "model_0.pt"
  runner.save(str(path))
  before = path.read_bytes()
  runner.train_iteration()
  save = torch.save

  def cut_save(obj, f, *args, **kwargs):
    save(obj, f, *args, **kwargs)
    Path(f).write_bytes(Path(f).read_bytes()[:100])  # a write cut short
    raise OSError("disk full")

  monkeypatch.setattr(torch, "save", cut_save)
  with pytest.raises(OSError, match="disk full"):
    runner.save(str(path))
  monkeypatch.undo()
  assert path.read_bytes() == before
  assert sorted(p.name for p in tmp_path.iterdir()) == ["model_0.pt", "model_0_policy.pt"]
  fresh = build_runner(TASK, TINY)
  fresh.load(str(path))
  saved = torch.load(path)["state"]
  for k, v in runner_state_to_arrays(fresh).items():
    np.testing.assert_array_equal(v, saved[k].numpy(), err_msg=k)


def test_save_flushes_each_file_before_its_rename_and_the_directory_after(tmp_path,
                                                                          monkeypatch):
  import os
  import stat

  from mjlab_tpu_torch.scripts.train import build_runner

  runner = build_runner(TASK, TINY)
  events = []
  fsync, replace = os.fsync, os.replace

  def record_fsync(fd):
    events.append("dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file")
    fsync(fd)

  def record_replace(src, dst):
    events.append(f"replace {Path(dst).name}")
    replace(src, dst)

  monkeypatch.setattr(os, "fsync", record_fsync)
  monkeypatch.setattr(os, "replace", record_replace)
  runner.save(str(tmp_path / "model_0.pt"))
  assert events == ["file", "replace model_0.pt", "dir",
                    "file", "replace model_0_policy.pt", "dir"]
