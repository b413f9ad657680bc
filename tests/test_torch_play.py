"""The port's headless run tools on the CPU at a tiny size: `play`'s
overrides change what the JAX package's change, `run_play --policy
trained` acts with the checkpoint's inference policy and prints the JAX
summary line, its viewer and video flags raise NotImplementedError,
`joint_deltas` gives the JAX script's table on the same targets, and
`list_envs` lists the port's tasks, each one of the JAX registry's."""

from __future__ import annotations

import copy
import re
import sys
import types

import numpy as np
import pytest
import torch

TASK = "Mjlab-Velocity-Flat-Unitree-G1"
TRACK = "Mjlab-Tracking-Flat-Unitree-G1"
ROUGH = "Mjlab-Velocity-Rough-Unitree-G1"
TINY = {
  "agent.num_steps_per_env": "2",
  "agent.policy.actor_hidden_dims": "(32, 32)",
  "agent.policy.critic_hidden_dims": "(32, 32)",
  "agent.algorithm.num_learning_epochs": "1",
  "agent.algorithm.num_mini_batches": "2",
  "agent.device": "cpu",
}
SUMMARY = re.compile(r"^\[play\] (\S+): (\d+) steps, mean reward/step (-?[\d.]+), base z \[(.*)\]$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
  from mjlab_tpu_torch.scripts.train import run_train

  log_dir = tmp_path_factory.mktemp("run")
  run_train(TASK, {**TINY, "env.scene.num_envs": "2", "agent.max_iterations": "1",
                   "log_dir": str(log_dir)})
  return log_dir / "model_1.pt"


def _leaves(cfg, iter_leaves) -> dict[str, str]:
  return {path: repr(v) for path, v in iter_leaves(cfg)}


def _play_changes(cfg, apply, iter_leaves):
  before = _leaves(cfg, iter_leaves)
  cfg = copy.deepcopy(cfg)
  apply(cfg)
  after = _leaves(cfg, iter_leaves)
  changed = {p: v for p, v in after.items() if before.get(p) != v}
  removed = {".".join(p.split(".")[:2]) for p in before if p not in after}
  return changed, removed


@pytest.mark.parametrize("task", [TASK, TRACK, ROUGH])
def test_play_overrides_match_jax(task):
  """The same changes as the JAX function; on a generator terrain the
  regenerated scene is the committed play npz, the JAX package's compile
  of the 3 x 3 terrain."""
  import mjlab_tpu.tasks as jax_tasks
  from mjlab_tpu.scripts.cli import iter_leaves as jax_iter_leaves
  from mjlab_tpu.scripts.play import apply_play_overrides as jax_apply
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.scripts.cli import iter_leaves
  from mjlab_tpu_torch.scripts.play import apply_play_overrides

  want = _play_changes(jax_tasks.load_cfg_from_registry(task, "env_cfg_entry_point"),
                       jax_apply, jax_iter_leaves)
  got = _play_changes(tasks.load_env_cfg(task), apply_play_overrides, iter_leaves)
  assert got == want
  changed, removed = got
  assert changed["episode_length_s"] == "1000000.0"
  assert changed["observations.policy.enable_corruption"] == "False"
  assert removed == {"events.push_robot"}
  if task == ROUGH:
    import torch_parity as tp
    from mjlab_tpu_torch import assets

    cfg = tasks.load_env_cfg(task)
    apply_play_overrides(cfg)
    assert tp.scene_mismatches(cfg.scene, assets.G1_VELOCITY_ROUGH_PLAY) == []


def test_play_trained_acts_with_the_checkpoints_policy(ckpt, capsys):
  from mjlab_tpu_torch.scripts.play import run_play
  from mjlab_tpu_torch.scripts.train import build_runner

  res = run_play(TASK, {**TINY, "checkpoint": str(ckpt), "num_envs": "2", "steps": "3"})
  line = capsys.readouterr().out.strip().splitlines()[-1]
  m = SUMMARY.match(line)
  assert m, line
  assert m.group(1) == TASK and int(m.group(2)) == 3
  assert float(m.group(3)) == pytest.approx(res.mean_reward, abs=5e-5)
  assert np.allclose([float(z) for z in m.group(4).split()], res.base_z, atol=5e-4)
  assert np.isfinite(res.mean_reward) and res.base_z.shape == (2,)
  assert res.env.cfg.episode_length_s == 1.0e6
  assert res.env.max_episode_length == 50_000_000
  runner = build_runner(TASK, {**TINY, "env.scene.num_envs": "2"})
  runner.load(str(ckpt))
  want = runner.get_inference_policy()(res.obs)
  torch.testing.assert_close(res.policy(res.obs), want, rtol=0, atol=0)


def test_play_zero_and_random_policies():
  from mjlab_tpu_torch.scripts.play import run_play

  zero = run_play(TASK, {**TINY, "num_envs": "2", "steps": "1"})
  assert torch.equal(zero.policy(zero.obs), torch.zeros(2, 29))
  rand = run_play(TASK, {**TINY, "policy": "random", "num_envs": "2", "steps": "1"})
  a = rand.policy(rand.obs)
  assert a.shape == (2, 29) and 0 < a.abs().max() < 1.0


@pytest.mark.parametrize("flag,value", [("viewer", "native"), ("viewer", "viser"),
                                        ("video", "out.mp4")])
def test_refused_flags_raise(flag, value):
  from mjlab_tpu_torch.scripts.play import run_play

  with pytest.raises(NotImplementedError, match=f"--{flag}"):
    run_play(TASK, {**TINY, flag: value})


@pytest.mark.parametrize("script", ["play", "joint_deltas"])
def test_unknown_flags_raise(script):
  from mjlab_tpu_torch.scripts.joint_deltas import run_joint_deltas
  from mjlab_tpu_torch.scripts.play import run_play

  run = run_play if script == "play" else run_joint_deltas
  with pytest.raises(ValueError, match="unknown flag --nmu_envs"):
    run(TASK, {**TINY, "nmu_envs": "2"})


def test_play_without_a_device_asks_for_cuda():
  from mjlab_tpu_torch.scripts.play import run_play

  overrides = {k: v for k, v in TINY.items() if k != "agent.device"}
  if torch.cuda.is_available():
    assert run_play(TASK, {**overrides, "steps": "1"}).env.device.type == "cuda"
    return
  with pytest.raises((RuntimeError, AssertionError)):
    run_play(TASK, {**overrides, "steps": "1"})


def test_joint_delta_table_matches_jax(monkeypatch, capsys):
  """JAX's script, run on a stand-in env whose joint action term hands out
  the given targets, prints the table the port builds from them."""
  import gymnasium
  import mjlab_tpu.scripts.joint_deltas as jax_joint_deltas
  from mjlab_tpu_torch.scripts.joint_deltas import HEADERS, joint_delta_rows
  from mjlab_tpu_torch.utils.logging import render_table

  T, B, A = 6, 3, 29
  targets = np.random.default_rng(0).normal(0.0, 0.5, (T, B, A))
  names = [f"joint_{j}" for j in range(A)]
  it = iter(targets)
  term = types.SimpleNamespace(_actuator_names=names)  # step() sets processed_actions
  env = types.SimpleNamespace(
    action_manager=types.SimpleNamespace(total_action_dim=A, get_term=lambda name: term),
    reset=lambda seed=None: (None, {}),
  )

  def step(action):
    term.processed_actions = next(it)
    return None, None, None, None, {}

  env.step = step
  monkeypatch.setattr(gymnasium, "make", lambda task, cfg=None: types.SimpleNamespace(
    unwrapped=env))
  monkeypatch.setattr(sys, "argv", ["joint_deltas", TASK, "--steps", str(T),
                                    "--num_envs", str(B)])
  jax_joint_deltas.main()
  want = capsys.readouterr().out.strip()
  got = render_table(f"Joint position targets over {T} steps × {B} envs", HEADERS,
                     joint_delta_rows(targets, names))
  assert got == want
  assert len(got.splitlines()) == 4 + A + 1


def test_joint_deltas_runs_on_a_checkpoint(ckpt):
  from mjlab_tpu_torch.scripts.joint_deltas import run_joint_deltas

  table = run_joint_deltas(TASK, {**TINY, "checkpoint": str(ckpt), "num_envs": "2",
                                  "steps": "3"}).splitlines()
  assert table[0] == "Joint position targets over 3 steps × 2 envs"
  assert len(table) == 4 + 29 + 1 and table[4].startswith("| left_hip_pitch_joint")


def test_list_envs_lists_the_ports_tasks(capsys):
  import mjlab_tpu.tasks as jax_tasks
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.scripts import list_envs

  list_envs.main()
  lines = capsys.readouterr().out.splitlines()
  assert lines[0].split() == ["Task", "ID", "Entry", "point"]
  rows = [line.split() for line in lines[2:]]
  assert [r[0] for r in rows] == tasks.list_tasks() and len(rows) == 10
  assert set(r[0] for r in rows) == set(jax_tasks.list_tasks())
  for task_id, entry in rows:
    module, attr = entry.split(":")
    assert module.startswith("mjlab_tpu_torch.tasks.") and callable(
      getattr(__import__(module, fromlist=[attr]), attr))
