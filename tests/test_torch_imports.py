"""The port stands alone: importing it, building and stepping its envs
(G1, Go1, Asimov and Asimov-Toe, flat and rough) from the committed scenes, one tiny PPO
training iteration, converting a motion
CSV and training the tracking task on it, and a run's lifecycle (training
with periodic saves, resuming, play, list_envs, joint_deltas, the NaN
guard, the artifact registry and the exporters, a user's task
registered with the sim-to-real cfg of chip_smoke.py's phase 15: per-env
randomization, history, delay, noise models, pushes and clip, a substep of
every surface scene and every muscle scene, the filter-actuated hopper
env, and the CartPole tutorial's port blocks, registered and stepped) pull
in none of jax,
jaxlib, mjlab_tpu, mujoco, gymnasium, flax, optax, orbax or wandb; no
module of the port and not chip_smoke.py names one of them in an import;
its own MuJoCo enum constants agree with mujoco's; and it registers every
task id the JAX package registers."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mjlab_tpu_torch.physics import types

ROOT = Path(__file__).resolve().parents[1]
# The port's scripts at the root of the repo, beside the package.
ROOT_SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]


def test_import_leaves_out_jax_mjlab_tpu_and_mujoco():
  code = (
    "import json, sys\n"
    "import mjlab_tpu_torch, mjlab_tpu_torch.sim, mjlab_tpu_torch.physics\n"
    "import mjlab_tpu_torch.kernels.chol, mjlab_tpu_torch.kernels.build\n"
    "import mjlab_tpu_torch.kernels.newton, mjlab_tpu_torch.kernels.pgs\n"
    "import mjlab_tpu_torch.assets\n"
    "import mjlab_tpu_torch.entity, mjlab_tpu_torch.scene, mjlab_tpu_torch.sensors\n"
    "import mjlab_tpu_torch.managers, mjlab_tpu_torch.envs, mjlab_tpu_torch.envs.mdp\n"
    "import mjlab_tpu_torch.tasks, mjlab_tpu_torch.tasks.velocity.mdp\n"
    "import mjlab_tpu_torch.utils.noise, mjlab_tpu_torch.asset_zoo.robots\n"
    "import mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants\n"
    "import mjlab_tpu_torch.rl, mjlab_tpu_torch.rl.runner, mjlab_tpu_torch.rl.exporter\n"
    "import mjlab_tpu_torch.rl.vecenv_wrapper, mjlab_tpu_torch.scripts.train\n"
    "import mjlab_tpu_torch.tasks.tracking.mdp, mjlab_tpu_torch.tasks.tracking.motions\n"
    "import mjlab_tpu_torch.tasks.tracking.config.g1.env_cfgs\n"
    "import mjlab_tpu_torch.physics.convex, mjlab_tpu_torch.envs.mdp.actions.ankle_ab_action\n"
    "import mjlab_tpu_torch.asset_zoo.robots.asimov.asimov_constants\n"
    "import mjlab_tpu_torch.asset_zoo.robots.asimov.asimov_toe_constants\n"
    "import mjlab_tpu_torch.tasks.velocity.config.asimov.env_cfgs\n"
    "import mjlab_tpu_torch.tasks.velocity.config.asimov_toe.env_cfgs\n"
    "import mjlab_tpu_torch.terrains, mjlab_tpu_torch.terrains.terrain_importer\n"
    "import mjlab_tpu_torch.asset_zoo.robots.unitree_go1.go1_constants\n"
    "import mjlab_tpu_torch.tasks.velocity.config.go1.env_cfgs\n"
    "import mjlab_tpu_torch.tasks.velocity.config.go1.rl_cfg\n"
    "import mjlab_tpu_torch.scripts.csv_to_npz as c2n\n"
    "m = mjlab_tpu_torch.assets.load_model_npz()\n"
    "import torch\n"
    "env = mjlab_tpu_torch.tasks.make_env('Mjlab-Velocity-Flat-Unitree-G1',\n"
    "                                     num_envs=2, device='cpu')\n"
    "env.reset(seed=0)\n"
    "env.step(torch.zeros(2, env.total_action_dim))\n"
    "for t in ('Mjlab-Velocity-Flat-Asimov', 'Mjlab-Velocity-Flat-Asimov-Toe',\n"
    "          'Mjlab-Velocity-Rough-Unitree-G1', 'Mjlab-Velocity-Flat-Unitree-Go1',\n"
    "          'Mjlab-Velocity-Rough-Unitree-Go1', 'Mjlab-Velocity-Rough-Asimov',\n"
    "          'Mjlab-Velocity-Rough-Asimov-Toe'):\n"
    "  e = mjlab_tpu_torch.tasks.make_env(t, num_envs=2, device='cpu')\n"
    "  e.reset(seed=0)\n"
    "  e.step(torch.zeros(2, e.total_action_dim))\n"
    "runner = mjlab_tpu_torch.scripts.train.build_runner(\n"
    "  'Mjlab-Velocity-Flat-Unitree-G1', {'env.scene.num_envs': '2',\n"
    "  'agent.num_steps_per_env': '2', 'agent.algorithm.num_mini_batches': '2',\n"
    "  'agent.algorithm.num_learning_epochs': '1',\n"
    "  'agent.policy.actor_hidden_dims': '(16,)',\n"
    "  'agent.policy.critic_hidden_dims': '(16,)'}, device='cpu')\n"
    "runner.train_iteration()\n"
    "import numpy as np, tempfile, os\n"
    "d = tempfile.mkdtemp()\n"
    "t = np.arange(16) / 30.0\n"
    "rows = np.concatenate([np.stack([0.1 * t, 0 * t, 0.78 + 0 * t], -1),\n"
    "  np.tile([1.0, 0, 0, 0], (16, 1)), 0.1 * np.sin(t[:, None] + np.zeros(29))], -1)\n"
    "np.savetxt(os.path.join(d, 'm.csv'), rows, delimiter=',')\n"
    "np.savez(os.path.join(d, 'm.npz'), **c2n.process(os.path.join(d, 'm.csv'), device='cpu'))\n"
    "runner = mjlab_tpu_torch.scripts.train.build_runner(\n"
    "  'Mjlab-Tracking-Flat-Unitree-G1', {'env.scene.num_envs': '2',\n"
    "  'agent.num_steps_per_env': '2', 'agent.algorithm.num_mini_batches': '2',\n"
    "  'agent.algorithm.num_learning_epochs': '1',\n"
    "  'agent.policy.actor_hidden_dims': '(16,)',\n"
    "  'agent.policy.critic_hidden_dims': '(16,)',\n"
    "  'motion_file': os.path.join(d, 'm.npz')}, device='cpu')\n"
    "runner.train_iteration()\n"
    "import mjlab_tpu_torch.utils.os, mjlab_tpu_torch.utils.logging\n"
    "import mjlab_tpu_torch.utils.artifacts, mjlab_tpu_torch.utils.nan_guard\n"
    "import mjlab_tpu_torch.rl.onnx_policy, mjlab_tpu_torch.scripts.play\n"
    "import mjlab_tpu_torch.scripts.joint_deltas, mjlab_tpu_torch.scripts.list_envs\n"
    "tiny = {'env.scene.num_envs': '2', 'agent.num_steps_per_env': '2',\n"
    "  'agent.algorithm.num_mini_batches': '2', 'agent.algorithm.num_learning_epochs': '1',\n"
    "  'agent.policy.actor_hidden_dims': '(16,)', 'agent.policy.critic_hidden_dims': '(16,)',\n"
    "  'agent.device': 'cpu', 'agent.max_iterations': '1', 'agent.save_interval': '1',\n"
    "  'enable_nan_guard': 'true', 'log_dir': os.path.join(d, 'run')}\n"
    "r = mjlab_tpu_torch.scripts.train.run_train('Mjlab-Velocity-Flat-Unitree-G1', tiny)\n"
    "r = mjlab_tpu_torch.scripts.train.run_train('Mjlab-Velocity-Flat-Unitree-G1',\n"
    "  {**tiny, 'agent.resume': 'true'})\n"
    "ck = os.path.join(d, 'run', 'model_2.pt')\n"
    "play = {k: v for k, v in tiny.items() if k.startswith('agent.')}\n"
    "mjlab_tpu_torch.scripts.play.run_play('Mjlab-Velocity-Flat-Unitree-G1',\n"
    "  {**play, 'checkpoint': ck, 'num_envs': '2', 'steps': '2'})\n"
    "mjlab_tpu_torch.scripts.joint_deltas.run_joint_deltas('Mjlab-Velocity-Flat-Unitree-G1',\n"
    "  {**play, 'checkpoint': ck, 'num_envs': '2', 'steps': '2'})\n"
    "mjlab_tpu_torch.scripts.list_envs.main()\n"
    "mjlab_tpu_torch.rl.onnx_policy.TorchScriptPolicy(ck.replace('.pt', '_policy.pt'))\n"
    "mjlab_tpu_torch.rl.exporter.export_policy_as_onnx(r, r.env, os.path.join(d, 'p.onnx'))\n"
    "import mjlab_tpu_torch.utils.buffers, chip_smoke\n"
    "def surface():\n"
    "  cfg = mjlab_tpu_torch.tasks.load_env_cfg('Mjlab-Velocity-Flat-Unitree-G1')\n"
    "  chip_smoke.sim_to_real_edit(cfg)\n"
    "  return cfg\n"
    "mjlab_tpu_torch.tasks.register('Sim-To-Real-G1', surface,\n"
    "  lambda: mjlab_tpu_torch.tasks.load_rl_cfg('Mjlab-Velocity-Flat-Unitree-G1'))\n"
    "e = mjlab_tpu_torch.tasks.make_env('Sim-To-Real-G1', num_envs=2, device='cpu')\n"
    "e.reset(seed=0)\n"
    "e.step(torch.zeros(2, e.total_action_dim))\n"
    "assert e.group_obs_dim['policy'] == (297,)\n"
    "reg = mjlab_tpu_torch.utils.artifacts.LocalRegistry(os.path.join(d, 'reg'))\n"
    "reg.publish(ck, 'runs/a')\n"
    "assert reg.resolve('runs/a:v1').is_dir()\n"
    "import re, pathlib, mjlab_tpu_torch.assets.surface_scenes as ss\n"
    "from mjlab_tpu_torch import physics\n"
    "for n in ss.SCENES:\n"
    "  tp, m = physics.put_model(ss.load(n), dtype=torch.float64, device='cpu')\n"
    "  physics.step(tp, m, physics.make_data(tp, m, 1))\n"
    "import mjlab_tpu_torch.kernels.pgs, mjlab_tpu_torch.physics.muscle\n"
    "import mjlab_tpu_torch.assets.muscle_scenes as ms\n"
    "for n in ms.SCENES:\n"
    "  mj = ms.load(n)\n"
    "  mj.opt.iterations, mj.opt.ls_iterations = 2, 2\n"
    "  tp, m = physics.put_model(mj, dtype=torch.float64, device='cpu')\n"
    "  physics.step(tp, m, physics.make_data(tp, m, 1))\n"
    "from mjlab_tpu_torch.envs import ManagerBasedRlEnv\n"
    "e = ManagerBasedRlEnv(ms.hopper_filter_env_cfg(2), device='cpu')\n"
    "e.reset(seed=0)\n"
    "e.step(torch.zeros(2, e.total_action_dim, dtype=torch.float64))\n"
    "doc = pathlib.Path('docs/CREATE_NEW_TASK_TORCH.md').read_text()\n"
    "ns = {}\n"
    "for b in re.findall(r'```python\\n(.*?)```', doc, flags=re.DOTALL):\n"
    "  if 'OnPolicyRunner(env' not in b:\n"
    "    exec(b, ns)\n"
    "e = mjlab_tpu_torch.tasks.make_env('Mjlab-Cartpole', num_envs=2, device='cpu')\n"
    "e.reset(seed=0)\n"
    "e.step(torch.zeros(2, e.total_action_dim))\n"
    "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in\n"
    "  ('jax', 'jaxlib', 'mjlab_tpu', 'mujoco', 'gymnasium', 'flax', 'optax',\n"
    "   'orbax', 'wandb'))))\n"
  )
  # One thread: a few-env CPU step is thousands of tiny ops.
  env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
  out = subprocess.run(
    [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
    text=True, timeout=300, check=True,
  )
  assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_module_of_the_port_names_jax_mjlab_tpu_or_mujoco():
  """A static check of every import statement, so that a module the first
  test does not load, and the scripts at the root, are held to the rule too."""
  banned = {"jax", "jaxlib", "mjlab_tpu", "mujoco", "gymnasium", "orbax", "wandb"}
  files = sorted((ROOT / "mjlab_tpu_torch").rglob("*.py")) + ROOT_SCRIPTS
  assert len(files) > 60
  found = []
  for path in files:
    for node in ast.walk(ast.parse(path.read_text())):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""]
      else:
        continue
      found += [(str(path.relative_to(ROOT)), n) for n in names
                if n.split(".")[0] in banned]
  assert found == []


def test_no_module_of_the_port_imports_by_a_built_name():
  """The static check above sees import statements only. A module named
  at run time escapes it, so only the task registry may import one: the
  registry's own entries name the port's modules, and a user's entry is
  the user's (`tasks.register`). chip_smoke.py builds its cfgs from the
  port's classes, imported by name; kernel_ab.py imports nothing by a
  built name either."""
  from mjlab_tpu_torch import tasks

  files = sorted((ROOT / "mjlab_tpu_torch").rglob("*.py")) + ROOT_SCRIPTS
  dynamic = []
  for path in files:
    for node in ast.walk(ast.parse(path.read_text())):
      if isinstance(node, ast.Call):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name in ("import_module", "__import__"):
          dynamic.append(str(path.relative_to(ROOT)))
  assert dynamic == ["mjlab_tpu_torch/tasks/__init__.py"]
  entries = [e for kinds in tasks._REGISTRY.values() for e in kinds.values()]
  assert len(entries) == 20
  assert all(e.startswith("mjlab_tpu_torch.") for e in entries)


@pytest.mark.parametrize(
  "enum",
  ["mjtJoint", "mjtGeom", "mjtSensor", "mjtObj", "mjtEq", "mjtBias", "mjtGain",
   "mjtDyn", "mjtTrn", "mjtWrap", "mjtIntegrator", "mjtSolver", "mjtCone",
   "mjtDisableBit"],
)
def test_enum_constants_match_mujoco(enum):
  import mujoco

  ours = getattr(types, enum)
  theirs = getattr(mujoco, enum)
  names = [n for n in vars(ours) if n.startswith("mj")]
  assert names
  for n in names:
    assert getattr(ours, n) == int(getattr(theirs, n)), f"{enum}.{n}"


def test_the_port_registers_every_task_of_the_jax_package():
  """The 10 ids the JAX package registers with gymnasium, each with the
  runner cfg its JAX registration names."""
  import mjlab_tpu.tasks as jax_tasks
  from mjlab_tpu_torch import tasks

  assert tasks.list_tasks() == sorted(jax_tasks.list_tasks())
  assert len(tasks.list_tasks()) == 10
  for task in tasks.list_tasks():
    jax_rl = jax_tasks.load_cfg_from_registry(task, "rl_cfg_entry_point")
    assert type(tasks.load_rl_cfg(task)).__name__ == type(jax_rl).__name__, task
