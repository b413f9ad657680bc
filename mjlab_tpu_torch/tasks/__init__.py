"""Task registry (the port's counterpart of mjlab_tpu/tasks/__init__.py,
without gymnasium): a task id maps to its env cfg factory, whose scene
names its compiled model, and to its PPO runner cfg. `make_env` builds the
env from the env cfg; `load_rl_cfg` gives the runner cfg.

    env = make_env("Mjlab-Velocity-Flat-Unitree-G1", num_envs=4096)
    obs, extras = env.reset(seed=0)
    obs, rew, terminated, time_outs, extras = env.step(action)

`register(task_id, env, rl)` adds a task of the user's own (an edited cfg).

The tracking tasks need a motion file (`cfg.commands["motion"].motion_file`;
`make_env` takes none, so build their env from `load_env_cfg`, or train
with `scripts.train ... --motion-file m.npz`).
"""

from __future__ import annotations

import importlib

_REGISTRY = {
  "Mjlab-Velocity-Flat-Unitree-G1": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs:unitree_g1_flat_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.g1.rl_cfg:UnitreeG1PPORunnerCfg",
  },
  "Mjlab-Velocity-Rough-Unitree-G1": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs:unitree_g1_rough_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.g1.rl_cfg:UnitreeG1PPORunnerCfg",
  },
  "Mjlab-Velocity-Rough-Unitree-Go1": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.go1.env_cfgs:unitree_go1_rough_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.go1.rl_cfg:UnitreeGo1PPORunnerCfg",
  },
  "Mjlab-Velocity-Flat-Unitree-Go1": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.go1.env_cfgs:unitree_go1_flat_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.go1.rl_cfg:UnitreeGo1PPORunnerCfg",
  },
  "Mjlab-Velocity-Rough-Asimov": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.asimov.env_cfgs:asimov_rough_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.asimov.rl_cfg:AsimovPPORunnerCfg",
  },
  "Mjlab-Velocity-Flat-Asimov": {
    "env": "mjlab_tpu_torch.tasks.velocity.config.asimov.env_cfgs:asimov_flat_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.velocity.config.asimov.rl_cfg:AsimovPPORunnerCfg",
  },
  "Mjlab-Velocity-Rough-Asimov-Toe": {
    "env": ("mjlab_tpu_torch.tasks.velocity.config.asimov_toe.env_cfgs:"
            "asimov_toe_rough_env_cfg"),
    "rl": "mjlab_tpu_torch.tasks.velocity.config.asimov_toe.rl_cfg:AsimovPPORunnerCfg",
  },
  "Mjlab-Velocity-Flat-Asimov-Toe": {
    "env": ("mjlab_tpu_torch.tasks.velocity.config.asimov_toe.env_cfgs:"
            "asimov_toe_flat_env_cfg"),
    "rl": "mjlab_tpu_torch.tasks.velocity.config.asimov_toe.rl_cfg:AsimovPPORunnerCfg",
  },
  "Mjlab-Tracking-Flat-Unitree-G1": {
    "env": "mjlab_tpu_torch.tasks.tracking.config.g1.env_cfgs:g1_flat_tracking_env_cfg",
    "rl": "mjlab_tpu_torch.tasks.tracking.config.g1.rl_cfg:G1FlatPPORunnerCfg",
  },
  "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation": {
    "env": ("mjlab_tpu_torch.tasks.tracking.config.g1.env_cfgs:"
            "g1_flat_tracking_no_state_estimation_env_cfg"),
    "rl": "mjlab_tpu_torch.tasks.tracking.config.g1.rl_cfg:G1FlatPPORunnerCfg",
  },
}


def list_tasks() -> list[str]:
  return sorted(_REGISTRY)


def register(task_id: str, env, rl) -> None:
  """Register a task of the user's own: `env` and `rl` are each a
  "module:attr" string or a callable that returns a fresh cfg (the JAX
  package registers such tasks with gymnasium). `build_runner`, `make_env`
  and the scripts then take the id."""
  _REGISTRY[task_id] = {"env": env, "rl": rl}


def _load(task_id: str, kind: str):
  if task_id not in _REGISTRY:
    raise KeyError(f"Unknown task '{task_id}'. Available: {list_tasks()}")
  entry = _REGISTRY[task_id][kind]
  if callable(entry):
    return entry()
  module, attr = entry.split(":")
  return getattr(importlib.import_module(module), attr)()


def load_env_cfg(task_id: str):
  """A fresh env cfg for the task."""
  return _load(task_id, "env")


def load_rl_cfg(task_id: str):
  """A fresh PPO runner cfg for the task."""
  return _load(task_id, "rl")


def make_env(task_id: str, num_envs: int | None = None, device=None, **cfg_overrides):
  """Build the task's ManagerBasedRlEnv on `device` (CUDA unless the caller
  asks for another) from its compiled scene. `cfg_overrides` set top-level
  cfg fields (e.g. seed, episode_length_s)."""
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv

  cfg = load_env_cfg(task_id)
  if num_envs is not None:
    cfg.scene.num_envs = num_envs
  for k, v in cfg_overrides.items():
    if not hasattr(cfg, k):
      raise AttributeError(f"env cfg has no field '{k}'")
    setattr(cfg, k, v)
  return ManagerBasedRlEnv(cfg, device=device)
