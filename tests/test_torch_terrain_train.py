"""Training G1 on rough terrain through the port's entry points on the CPU
at a tiny size: `python -m mjlab_tpu_torch.scripts.train
Mjlab-Velocity-Rough-Unitree-G1 --env.scene.num_envs 2 ...` (the G1 PPO
cfg; the terrain curriculum logs its mean level); `play` on the
checkpoint, which regenerates the terrain on 3 x 3 tiles without the
curriculum, the committed play scene; and the play overrides against the
JAX package's."""

from __future__ import annotations

import copy
import math

import pytest
import torch

import torch_parity as tp

TASK = "Mjlab-Velocity-Rough-Unitree-G1"


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
  final = tp.check_trained(log_dir, stdout, 99, 29)
  assert 0.0 <= final["Curriculum/terrain_levels"] <= 9.0
  assert final["Metrics/physics/terrain_slots_dropped"] == 0.0


def test_play_loads_the_play_scene(trained):
  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.scripts.play import run_play

  log_dir, _ = trained
  res = run_play(TASK, {"agent.device": "cpu", "checkpoint": str(log_dir / "model_1.pt"),
                        "num_envs": "2", "steps": "3"})
  env = res.env
  assert env.cfg.scene.model_file == assets.G1_VELOCITY_FLAT
  assert tp.scene_mismatches(env.cfg.scene, assets.G1_VELOCITY_ROUGH_PLAY) == []
  assert env.scene.terrain.terrain_origins.shape == (3, 3, 3)
  assert len(env.tp.terrain_groups[0].pool_geoms) == 237
  assert math.isfinite(res.mean_reward) and (res.base_z > 0.3).all()


def test_play_overrides_match_jax():
  """The same terrain and episode changes as the JAX function, and the
  regenerated scene is the committed play npz, the JAX package's compile
  of that terrain."""
  from mjlab_tpu_torch import assets
  from mjlab_tpu_torch.scripts.play import apply_play_overrides
  from mjlab_tpu_torch.tasks import load_env_cfg

  jcfg, jplay = tp.rough_jax_cfg("g1"), tp.rough_jax_cfg("g1", play=True)
  cfg = load_env_cfg(TASK)
  play = copy.deepcopy(cfg)
  apply_play_overrides(play)
  def grid(c):
    gen = c.scene.terrain.terrain_generator
    return gen.num_rows, gen.num_cols, gen.curriculum

  assert (grid(cfg), grid(play)) == (grid(jcfg), grid(jplay)) == ((10, 20, True), (3, 3, False))
  assert play.episode_length_s == jplay.episode_length_s == 1.0e6
  assert "push_robot" not in play.events and "push_robot" not in jplay.events
  assert play.scene.model_file == cfg.scene.model_file == assets.G1_VELOCITY_FLAT
  assert tp.scene_mismatches(play.scene, assets.G1_VELOCITY_ROUGH_PLAY) == []
  flat = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
  apply_play_overrides(flat)
  assert flat.scene.model_file == assets.G1_VELOCITY_FLAT
