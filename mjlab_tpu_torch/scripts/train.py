"""Training entry point of the port (mjlab_tpu/scripts/train.py on one GPU).

Usage:
  python -m mjlab_tpu_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \
      --env.scene.num_envs 4096 --agent.max_iterations 1000 [--log_dir d]

Trains on CUDA unless `--agent.device cpu`. `--env.<field>` and
`--agent.<field>` override any field of the task's env cfg and PPO runner
cfg. A tracking task takes its motion as `--motion-file m.npz` (or
`--motion_file`; make one with `mjlab_tpu_torch.scripts.csv_to_npz`), which
sets `commands.motion.motion_file`. At the end it saves
`model_<iteration>.pt` (the learner's state), the
TorchScript policy `model_<iteration>_policy.pt` and `final_metrics.json`
under the log dir (default logs/<experiment_name>).

The JAX script's multi-device, video, artifact-registry (`--registry-name`),
NaN-guard and profiler flags are not ported; each raises
NotImplementedError.
"""

from __future__ import annotations

import json
import os
import sys

_UNPORTED = (
  "mesh", "video", "video_interval", "registry_name", "enable_nan_guard", "profile",
)


def _split(overrides: dict[str, str]) -> tuple[dict[str, str], dict[str, str]]:
  for key in overrides:
    name = key.replace("-", "_")
    if name in _UNPORTED:
      raise NotImplementedError(f"--{key} is not supported by mjlab_tpu_torch's train")
    if not key.startswith(("env.", "agent.")) and name not in ("log_dir", "motion_file"):
      raise ValueError(f"unknown flag --{key}")
  env_over = {k[4:]: v for k, v in overrides.items() if k.startswith("env.")}
  agent_over = {k[6:]: v for k, v in overrides.items() if k.startswith("agent.")}
  motion = overrides.get("motion_file") or overrides.get("motion-file")
  if motion:
    env_over["commands.motion.motion_file"] = motion
  return env_over, agent_over


def build_runner(task: str, overrides: dict[str, str], device=None):
  """The task's env and PPO runner, with the CLI's overrides
  ({"env.scene.num_envs": "4096", "agent.seed": "1", "log_dir": ...,
  "motion_file": ...}), on
  `device` (else the runner cfg's device, CUDA by default)."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.cli import apply_overrides

  env_over, agent_over = _split(overrides)
  env_cfg = tasks.load_env_cfg(task)
  if "commands.motion.motion_file" in env_over and "motion" not in (env_cfg.commands or {}):
    raise ValueError(f"--motion-file: task {task} has no motion command")
  agent_cfg = tasks.load_rl_cfg(task)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  if agent_cfg.resume:
    raise NotImplementedError("--agent.resume is not supported by mjlab_tpu_torch's train")
  log_dir = overrides.get("log_dir", os.path.join("logs", agent_cfg.experiment_name))
  env = ManagerBasedRlEnv(env_cfg, device=device or agent_cfg.device)
  return OnPolicyRunner(env, agent_cfg, log_dir=log_dir)


def run_train(task: str, overrides: dict[str, str]) -> None:
  runner = build_runner(task, overrides)
  os.makedirs(runner.log_dir, exist_ok=True)
  print(f"[train] task={task} num_envs={runner.env.num_envs} device={runner.device}",
        flush=True)
  runner.learn(runner.cfg.max_iterations)
  runner.save(os.path.join(runner.log_dir, f"model_{runner.iteration}.pt"))
  if runner.last_metrics is not None:
    with open(os.path.join(runner.log_dir, "final_metrics.json"), "w") as f:
      json.dump({"iteration": runner.iteration, **runner.last_metrics}, f)


def main() -> None:
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.scripts.cli import format_help, parse_args

  positionals, overrides = parse_args(sys.argv[1:])
  if not positionals:
    print("usage: train <Task-ID> [--env.x.y v] [--agent.x v] [--log_dir d]")
    print("run `train <Task-ID> --help` to list every overridable field")
    print("available tasks:")
    for t in tasks.list_tasks():
      print(f"  {t}")
    sys.exit(1)
  task = positionals[0]
  if "help" in overrides:
    print(format_help(
      {"env": tasks.load_env_cfg(task), "agent": tasks.load_rl_cfg(task)},
      usage=f"usage: train {task} [--env.<field> v] [--agent.<field> v] [--log_dir d]",
    ))
    sys.exit(0)
  run_train(task, overrides)


if __name__ == "__main__":
  main()
