"""The CartPole tutorial on the port (docs/CREATE_NEW_TASK_TORCH.md): the
committed scene is fresh (the JAX tutorial env's compile,
docs/CREATE_NEW_TASK.md run verbatim); the port guide's python blocks run
verbatim and register the task; its env, given the JAX tutorial env's
state, steps within 1e-8 of it in float64 (PERF.md §2); two PPO
iterations train; and the `mjlab_tpu_torch.tasks` entry-point group makes
a third-party package's task available to the scripts, with a failing
plugin's error raised (the JAX package swallows it: ROADMAP Queue C).

Regenerate the scene with:
PYTHONPATH=.:tests JAX_PLATFORMS=cpu python -c "import torch_parity as tp; tp.save_cartpole_npz()"
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu_torch import assets, tasks
from tests import torch_parity as tp

ROOT = Path(__file__).resolve().parents[1]
NUM_ENVS, STEPS, TOL = 4, 8, 1e-8


@pytest.fixture(scope="module")
def tutorial():
  """The JAX tutorial env (float64, 4 envs, reset), and the namespace of
  the port guide's blocks (the port's task registered while the module
  runs)."""
  had = tp.CARTPOLE_ID in tasks._REGISTRY
  jenv, _ = tp.cartpole_jax_env(NUM_ENVS, dtype="float64")
  jenv.reset(seed=0)
  with tp.torch_threads(1):
    ns = tp.run_doc("CREATE_NEW_TASK_TORCH.md")
  yield jenv, ns
  if not had:
    tasks._REGISTRY.pop(tp.CARTPOLE_ID, None)


def test_npz_is_fresh(tutorial, tmp_path):
  jenv, _ = tutorial
  fresh = tmp_path / "cartpole.npz"
  assets.save_model_npz(jenv.sim.mj_model, fresh)
  with np.load(fresh) as a, np.load(assets.CARTPOLE) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


def test_guide_blocks_run_and_register(tutorial):
  """Every block but the full-scale run executed; the task is registered
  with the default runner cfg and builds with the JAX tutorial's shapes."""
  _, ns = tutorial
  blocks = tp.doc_blocks("CREATE_NEW_TASK_TORCH.md")
  assert len(blocks) >= 8 and sum("OnPolicyRunner(env" in b for b in blocks) == 1
  assert "jax" not in "".join(blocks) and "mjlab_tpu." not in "".join(blocks)
  assert tp.CARTPOLE_ID in tasks.list_tasks()
  assert type(tasks.load_rl_cfg(tp.CARTPOLE_ID)).__name__ == "RlOnPolicyRunnerCfg"
  cfg = tasks.load_env_cfg(tp.CARTPOLE_ID)
  assert (cfg.decimation, cfg.episode_length_s, cfg.scene.model_file) == (2, 10.0,
                                                                          assets.CARTPOLE)


def test_env_steps_match_jax(tutorial):
  """The port env (from the committed npz) takes the JAX env's post-reset
  state and steps with it: observations, rewards, terminations and qpos."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  jenv, ns = tutorial
  cfg = copy.deepcopy(ns["create_cartpole_env_cfg"](num_envs=NUM_ENVS))
  cfg.sim.dtype = "float64"
  with tp.torch_threads(1):
    env = ManagerBasedRlEnv(cfg, device="cpu")
    assert env.group_obs_dim == jenv.observation_manager.group_obs_dim == {"policy": (4,)}
    assert env.total_action_dim == jenv.action_manager.total_action_dim == 1
    tp.carry(jenv, env, full=True)
    for i, a in enumerate(tp.actions(3, STEPS, NUM_ENVS, 1)):
      (jo, jr, jt, jto, _) = tp.numpy_tree(jenv.step(jnp.asarray(a)))
      (to, tr, tt, tto, _) = tp.numpy_tree(env.step(torch.as_tensor(a)))
      tp.assert_close(to["policy"], jo["policy"], TOL, f"policy, step {i}")
      tp.assert_close(tr, jr, TOL, f"reward, step {i}")
      np.testing.assert_array_equal(tt, jt)
      np.testing.assert_array_equal(tto, jto)
    tp.assert_close(env.data.qpos.numpy(), np.asarray(jenv.data.qpos), TOL, "qpos")
  assert np.abs(np.asarray(jenv.data.qpos)[:, 1]).max() > 0.01  # the pole moved


def test_two_iterations_train(tutorial):
  """The guide's runner helper on the CPU, 4 envs x 4 steps: two PPO
  iterations with finite losses that move the policy."""
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays

  _, ns = tutorial
  with tp.torch_threads(1):
    runner = ns["cartpole_runner"](NUM_ENVS, device="cpu", num_steps_per_env=4)
    before = runner_state_to_arrays(runner)
    for _ in range(2):
      metrics = runner.train_iteration()
  assert all(np.isfinite(float(metrics[k])) for k in ("Loss/loss", "Loss/value_loss"))
  after = runner_state_to_arrays(runner)
  assert max(np.abs(after[k] - before[k]).max() for k in after if k.startswith("params/")) > 0


def _plugin(tmp_path: Path, body: str) -> dict:
  """A package `cartpole_plugin` named in the mjlab_tpu_torch.tasks and
  mjlab_tpu.tasks entry-point groups of a dist-info on PYTHONPATH."""
  (tmp_path / "cartpole_plugin.py").write_text(textwrap.dedent(body))
  dist = tmp_path / "cartpole_plugin-0.1.dist-info"
  dist.mkdir()
  (dist / "METADATA").write_text("Metadata-Version: 2.1\nName: cartpole-plugin\nVersion: 0.1\n")
  (dist / "entry_points.txt").write_text(
    "[mjlab_tpu_torch.tasks]\ncartpole = cartpole_plugin\n\n"
    "[mjlab_tpu.tasks]\ncartpole = cartpole_plugin\n")
  env = dict(os.environ)
  env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT)])
  return env


def test_entry_point_group_registers_a_plugins_task(tmp_path):
  """list_envs imports the group's modules when it starts: the plugin runs
  the guide's registration and its task is listed."""
  blocks = "\n".join(b for b in tp.doc_blocks("CREATE_NEW_TASK_TORCH.md")
                     if "OnPolicyRunner(env" not in b)
  env = _plugin(tmp_path, blocks)
  out = subprocess.run([sys.executable, "-m", "mjlab_tpu_torch.scripts.list_envs"],
                       capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
  assert out.returncode == 0, out.stderr
  assert "Mjlab-Cartpole" in out.stdout


def test_a_failing_plugin_raises_naming_its_entry_point(tmp_path):
  """A plugin that raises on import stops list_envs with its own error
  and a note naming the entry point; the JAX package's loader swallows the
  same error (ROADMAP Queue C)."""
  env = _plugin(tmp_path, "raise RuntimeError('plugin is broken')\n")
  out = subprocess.run([sys.executable, "-m", "mjlab_tpu_torch.scripts.list_envs"],
                       capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
  assert out.returncode != 0
  assert "plugin is broken" in out.stderr
  assert "mjlab_tpu_torch.tasks entry point 'cartpole = cartpole_plugin'" in out.stderr
  code = "import mjlab_tpu.tasks as t; t._import_external_tasks(); print('swallowed')"
  out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**env, "JAX_PLATFORMS": "cpu"}, timeout=300, cwd=tmp_path)
  assert out.returncode == 0 and "swallowed" in out.stdout, out.stderr
