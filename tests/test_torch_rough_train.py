"""Training Go1, Asimov and Asimov-Toe on rough terrain through the port's
entry points on the CPU at a tiny size: `python -m
mjlab_tpu_torch.scripts.train Mjlab-Velocity-Rough-Asimov
--env.scene.num_envs 2 ...` (each task's PPO cfg, the flat variant's, as
the JAX registry gives it; the terrain curriculum logs its mean level);
`play` on the checkpoint, which regenerates the terrain on 3 x 3 tiles
without the curriculum, the task's committed play scene; and the play
overrides against the JAX package's."""

from __future__ import annotations

import copy
import math

import pytest
import torch

import torch_parity as tp

TASKS = {  # task id: (ROUGH key, policy obs width, actions)
  "Mjlab-Velocity-Rough-Unitree-Go1": ("go1", 48, 12),
  "Mjlab-Velocity-Rough-Asimov": ("asimov", 48, 12),
  "Mjlab-Velocity-Rough-Asimov-Toe": ("asimov_toe", 45, 12),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(TASKS))
def trained(request, tmp_path_factory):
  task = request.param
  log_dir = tmp_path_factory.mktemp("train")
  return task, log_dir, tp.train_cli(task, log_dir)


def test_train_cli_runs_one_iteration(trained):
  task, log_dir, stdout = trained
  _, obs_dim, num_actions = TASKS[task]
  final = tp.check_trained(log_dir, stdout, obs_dim, num_actions)
  assert 0.0 <= final["Curriculum/terrain_levels"] <= 9.0
  assert math.isfinite(final["Metrics/physics/terrain_slots_dropped"])


def test_play_loads_the_play_scene(trained):
  from mjlab_tpu_torch.scripts.play import run_play

  task, log_dir, _ = trained
  res = run_play(task, {"agent.device": "cpu", "checkpoint": str(log_dir / "model_1.pt"),
                        "num_envs": "2", "steps": "3"})
  env = res.env
  assert tp.scene_mismatches(env.cfg.scene, tp.rough_npz(TASKS[task][0], play=True)) == []
  assert env.scene.terrain.terrain_origins.shape == (3, 3, 3)
  assert 64 < len(env.tp.terrain_groups[0].pool_geoms) < 300
  assert math.isfinite(res.mean_reward) and (res.base_z > 0.1).all()


@pytest.mark.parametrize("task", list(TASKS))
def test_play_overrides_match_jax(task):
  """The same terrain and episode changes as the JAX function, and the
  regenerated scene is the committed play npz, the JAX package's compile
  of that terrain."""
  from mjlab_tpu_torch.scripts.play import apply_play_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  name = TASKS[task][0]
  jcfg, jplay = tp.rough_jax_cfg(name), tp.rough_jax_cfg(name, play=True)
  cfg = load_env_cfg(task)
  play = copy.deepcopy(cfg)
  apply_play_overrides(play)

  def grid(c):
    gen = c.scene.terrain.terrain_generator
    return gen.num_rows, gen.num_cols, gen.curriculum

  assert (grid(cfg), grid(play)) == (grid(jcfg), grid(jplay)) == ((10, 20, True), (3, 3, False))
  assert play.episode_length_s == jplay.episode_length_s == 1.0e6
  assert tp.scene_mismatches(cfg.scene, tp.rough_npz(name)) == []
  assert tp.scene_mismatches(play.scene, tp.rough_npz(name, play=True)) == []
