"""The port's local artifact registry against the JAX package's on one temp
tree: publish, resolve `latest`/`vN`, the errors for what is missing and
`resolve_motion_file` agree; `get_checkpoint_path` resolves the version
before its cache, so a second publish is picked up where the JAX function
returns its stale cache (the declared divergence), and two names that end
alike keep apart; `--registry-name` reaches the tracking task's motion
command through train."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

TRACK = "Mjlab-Tracking-Flat-Unitree-G1"


@pytest.fixture
def registry(tmp_path, monkeypatch):
  root = tmp_path / "registry"
  monkeypatch.setenv("MJLAB_REGISTRY_DIR", str(root))
  monkeypatch.delenv("WANDB_API_KEY", raising=False)
  return root


def _both():
  from mjlab_tpu.utils import artifacts as jax_artifacts
  from mjlab_tpu_torch.utils import artifacts

  return jax_artifacts, artifacts


def test_get_registry_is_the_local_one(registry):
  jax_artifacts, artifacts = _both()
  assert isinstance(artifacts.get_registry(), artifacts.LocalRegistry)
  assert isinstance(jax_artifacts.get_registry(), jax_artifacts.LocalRegistry)
  assert artifacts.get_registry().root == jax_artifacts.get_registry().root == registry


@pytest.mark.parametrize("publisher", ["jax", "torch"])
def test_publish_and_resolve_match_jax(registry, tmp_path, publisher):
  jax_artifacts, artifacts = _both()
  regs = {"jax": jax_artifacts.LocalRegistry(), "torch": artifacts.LocalRegistry()}
  src = tmp_path / "policy.pt"
  dirsrc = tmp_path / "bundle"
  dirsrc.mkdir()
  (dirsrc / "a.txt").write_text("a")
  dsts = []
  for i, path in enumerate((src, dirsrc, src)):
    if path is src:
      src.write_text(f"version {i}")
    dsts.append(regs[publisher].publish(path, "policies/g1"))
  assert [d.name for d in dsts] == ["v1", "v2", "v3"]
  for name in ("policies/g1", "policies/g1:latest", "policies/g1:v1", "policies/g1:v2"):
    assert regs["torch"].resolve(name) == regs["jax"].resolve(name), name
  assert (regs["torch"].resolve("policies/g1") / "policy.pt").read_text() == "version 2"
  assert (regs["torch"].resolve("policies/g1:v2") / "bundle" / "a.txt").is_file()
  for name in ("policies/missing", "policies/g1:v9", "policies/g1:best"):
    errors = []
    for reg in regs.values():
      with pytest.raises(FileNotFoundError) as e:
        reg.resolve(name)
      errors.append(str(e.value))
    assert errors[0] == errors[1].replace("LocalRegistry.publish", "ArtifactRegistry.publish")
  with pytest.raises(FileNotFoundError):
    regs["torch"].publish(tmp_path / "absent.pt", "policies/g1")


def test_resolve_motion_file_matches_jax(registry, tmp_path):
  jax_artifacts, artifacts = _both()
  reg = artifacts.LocalRegistry()
  named = tmp_path / "motion.npz"
  np.savez(named, a=np.zeros(1))
  other = tmp_path / "walk.npz"
  np.savez(other, a=np.ones(1))
  reg.publish(named, "motions/named")
  reg.publish(other, "motions/other")
  two = tmp_path / "two"
  two.mkdir()
  for n in ("x.npz", "y.npz"):
    np.savez(two / n, a=np.zeros(1))
  reg.publish(two, "motions/two")
  for name in ("motions/named", "motions/other:v1"):
    got = artifacts.resolve_motion_file(name)
    assert got == jax_artifacts.resolve_motion_file(name)
    assert Path(got).is_file()
  for name in ("motions/two", "motions/none"):
    with pytest.raises(FileNotFoundError):
      artifacts.resolve_motion_file(name)
    with pytest.raises(FileNotFoundError):
      jax_artifacts.resolve_motion_file(name)


def test_get_checkpoint_path_sees_a_second_publish_where_jax_returns_its_cache(
    registry, tmp_path):
  """ROADMAP Queue C: the JAX function checks its cache before the
  registry, so `:latest` stays at the first version it cached. The port
  resolves the version first."""
  jax_artifacts, artifacts = _both()
  logs = {"jax": tmp_path / "jax_logs", "torch": tmp_path / "torch_logs"}
  names = {"jax": "runs/exp1_jax", "torch": "runs/exp1"}

  def publish(k: int) -> None:
    for pkg in ("jax", "torch"):
      art = tmp_path / f"{pkg}_art{k}"
      art.mkdir()
      if pkg == "jax":
        (art / f"model_{k}").mkdir()  # an Orbax checkpoint directory
        (art / f"model_{k}" / "state").write_text(str(k))
      else:
        torch.save({"iteration": k}, art / f"model_{k}.pt")
        (art / f"model_{k}_policy.pt").write_text("")
      artifacts.LocalRegistry().publish(art, names[pkg])  # as <name>/v<k>/<pkg>_art<k>/

  publish(1)
  got, cached = artifacts.get_checkpoint_path(logs["torch"], names["torch"])
  assert got.name == "model_1.pt" and not cached and torch.load(got)["iteration"] == 1
  assert got.parent.name == "runs_exp1_v1"
  want, jax_cached = jax_artifacts.get_checkpoint_path(logs["jax"], names["jax"])
  assert want.name == "model_1" and not jax_cached
  got, cached = artifacts.get_checkpoint_path(logs["torch"], names["torch"])
  assert got.name == "model_1.pt" and cached

  publish(2)
  got, cached = artifacts.get_checkpoint_path(logs["torch"], names["torch"])
  assert got.name == "model_2.pt" and not cached and torch.load(got)["iteration"] == 2
  want, jax_cached = jax_artifacts.get_checkpoint_path(logs["jax"], names["jax"])
  assert want.name == "model_1" and jax_cached  # the JAX package's stale cache
  got, cached = artifacts.get_checkpoint_path(logs["torch"], names["torch"] + ":v1")
  assert got.name == "model_1.pt" and cached


def test_get_checkpoint_path_keeps_names_that_end_alike_apart(registry, tmp_path):
  _, artifacts = _both()
  for i, name in enumerate(("runs/exp1", "other/exp1")):
    art = tmp_path / f"art{i}"
    art.mkdir()
    torch.save({"iteration": 10 + i}, art / f"model_{10 + i}.pt")
    artifacts.LocalRegistry().publish(art / f"model_{10 + i}.pt", name)
  a, _ = artifacts.get_checkpoint_path(tmp_path / "logs", "runs/exp1")
  b, cached = artifacts.get_checkpoint_path(tmp_path / "logs", "other/exp1")
  assert a.parent != b.parent and not cached
  assert torch.load(a)["iteration"] == 10 and torch.load(b)["iteration"] == 11
  with pytest.raises(FileNotFoundError, match="no model_"):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "notes.txt").write_text("")
    artifacts.LocalRegistry().publish(tmp_path / "empty" / "notes.txt", "runs/empty")
    artifacts.get_checkpoint_path(tmp_path / "logs", "runs/empty")


def test_registry_name_reaches_the_motion_command_through_train(registry, tmp_path):
  from mjlab_tpu_torch.tasks.tracking.motions import make_standing_motion
  from mjlab_tpu_torch.scripts.train import run_train
  from mjlab_tpu_torch.utils.artifacts import LocalRegistry

  n = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    motion = tmp_path / "motion.npz"
    make_standing_motion(str(motion), device="cpu")
    dst = LocalRegistry().publish(motion, "motions/stand")
    runner = run_train(TRACK, {
      "env.scene.num_envs": "2", "agent.num_steps_per_env": "2", "agent.max_iterations": "1",
      "agent.policy.actor_hidden_dims": "(16,)", "agent.policy.critic_hidden_dims": "(16,)",
      "agent.algorithm.num_learning_epochs": "1", "agent.algorithm.num_mini_batches": "2",
      "agent.device": "cpu", "registry-name": "motions/stand:latest",
      "log_dir": str(tmp_path / "run"),
    })
  finally:
    torch.set_num_threads(n)
  assert runner.env.cfg.commands["motion"].motion_file == str(dst / "motion.npz")
  assert runner.iteration == 1 and (tmp_path / "run" / "model_1.pt").is_file()


def test_save_publishes_the_policy_when_asked(registry, tmp_path, monkeypatch, capsys):
  """MJLAB_REGISTRY_PUBLISH=1: each save publishes its TorchScript policy as
  policies/<experiment_name>; a failed publish is reported as such and the
  checkpoint stays written."""
  from mjlab_tpu_torch.scripts.train import build_runner
  from mjlab_tpu_torch.utils import artifacts

  runner = build_runner("Mjlab-Velocity-Flat-Unitree-G1", {
    "env.scene.num_envs": "2", "agent.policy.actor_hidden_dims": "(16,)",
    "agent.policy.critic_hidden_dims": "(16,)", "agent.device": "cpu"})
  runner.save(str(tmp_path / "model_0.pt"))
  assert not registry.exists()
  monkeypatch.setenv("MJLAB_REGISTRY_PUBLISH", "1")
  runner.save(str(tmp_path / "model_0.pt"))
  runner.save(str(tmp_path / "model_1.pt"))
  got = artifacts.LocalRegistry().resolve("policies/g1_velocity")
  assert got.name == "v2" and (got / "model_1_policy.pt").is_file()
  assert "policy published: policies/g1_velocity" in capsys.readouterr().out

  def refuse(self, path, name):
    raise PermissionError("read-only registry")

  monkeypatch.setattr(artifacts.LocalRegistry, "publish", refuse)
  runner.save(str(tmp_path / "model_2.pt"))
  out = capsys.readouterr().out
  assert "policy publish skipped: read-only registry" in out and "export" not in out
  assert (tmp_path / "model_2.pt").is_file() and (tmp_path / "model_2_policy.pt").is_file()
