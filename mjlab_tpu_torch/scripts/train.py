"""Training entry point of the port (mjlab_tpu/scripts/train.py on one GPU).

Usage:
  python -m mjlab_tpu_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \
      --env.scene.num_envs 4096 --agent.max_iterations 1000 [--log_dir d] \
      [--agent.save_interval 50] [--agent.resume true] [--enable_nan_guard] \
      [--profile n] [--motion-file m.npz | --registry-name name[:alias]]

Trains on CUDA unless `--agent.device cpu`. `--env.<field>` and
`--agent.<field>` override any field of the task's env cfg and PPO runner
cfg. Under the log dir (default logs/<experiment_name>) it writes
`agent_cfg.yaml`, then, as it trains, `metrics.jsonl` (a line per
iteration, pulled every 10 iterations) and every `save_interval` iterations
a checkpoint `model_<iteration>.pt` with its TorchScript policy
`model_<iteration>_policy.pt`; at the end `model_<iterations done>.pt` and
`final_metrics.json`.

- `--agent.resume true` loads the newest checkpoint of the log dir
  (`utils.os.resolve_latest_checkpoint`) and trains `max_iterations` more;
  with none it starts fresh. As in the JAX package, the env state and the
  runner's generator start anew.
- A tracking task takes its motion as `--motion-file m.npz` (or
  `--motion_file`; make one with `mjlab_tpu_torch.scripts.csv_to_npz`), or
  as `--registry-name` (`--registry_name`) from the local artifact
  registry (`utils.artifacts`); the file wins.
- `--enable_nan_guard` checks the env's state after each iteration
  (`utils.nan_guard`); on the first NaN it dumps to <log_dir>/nan_dumps and
  raises RuntimeError.
- `--profile n` traces the first n iterations with torch.profiler (CUDA
  activity on the card) into <log_dir>/profile/, then trains the rest.

The JAX script's multi-device (`--mesh`) and video (`--video`,
`--video_interval`) flags are not ported; each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

_UNPORTED = ("mesh", "video", "video_interval")
_FLAGS = ("log_dir", "motion_file", "registry_name", "enable_nan_guard", "profile")


def _split(overrides: dict[str, str]) -> tuple[dict[str, str], dict[str, str]]:
  from mjlab_tpu_torch.scripts.cli import check_flags, get_flag

  check_flags(overrides, _FLAGS, "train", unported=_UNPORTED)
  env_over = {k[4:]: v for k, v in overrides.items() if k.startswith("env.")}
  agent_over = {k[6:]: v for k, v in overrides.items() if k.startswith("agent.")}
  motion = get_flag(overrides, "motion_file")
  registry_name = get_flag(overrides, "registry_name")
  if not motion and registry_name:
    from mjlab_tpu_torch.utils.artifacts import resolve_motion_file

    motion = resolve_motion_file(registry_name)
    print(f"[train] registry artifact {registry_name} -> {motion}")
  if motion:
    env_over["commands.motion.motion_file"] = motion
  return env_over, agent_over


def build_runner(task: str, overrides: dict[str, str], device=None):
  """The task's env and PPO runner, with the CLI's overrides
  ({"env.scene.num_envs": "4096", "agent.seed": "1", "log_dir": ...,
  "motion_file": ...}), on `device` (else the runner cfg's device, CUDA by
  default)."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.cli import apply_overrides

  env_over, agent_over = _split(overrides)
  env_cfg = tasks.load_env_cfg(task)
  if "commands.motion.motion_file" in env_over and "motion" not in (env_cfg.commands or {}):
    raise ValueError(f"--motion-file / --registry-name: task {task} has no motion command")
  agent_cfg = tasks.load_rl_cfg(task)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  log_dir = overrides.get("log_dir", os.path.join("logs", agent_cfg.experiment_name))
  env = ManagerBasedRlEnv(env_cfg, device=device or agent_cfg.device)
  return OnPolicyRunner(env, agent_cfg, log_dir=log_dir)


def run_train(task: str, overrides: dict[str, str]):
  """Build the runner, resume or guard it as the flags ask, train, save the
  final checkpoint and final_metrics.json. Returns the runner."""
  from mjlab_tpu_torch.scripts.cli import get_flag
  from mjlab_tpu_torch.utils.os import dump_yaml, resolve_latest_checkpoint

  runner = build_runner(task, overrides)
  log_dir, cfg = runner.log_dir, runner.cfg
  os.makedirs(log_dir, exist_ok=True)
  print(f"[train] task={task} num_envs={runner.env.num_envs} device={runner.device}",
        flush=True)

  if (get_flag(overrides, "enable_nan_guard") or "false").lower() in ("1", "true"):
    from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

    guard = NanGuard(NanGuardCfg(enabled=True, output_dir=os.path.join(log_dir, "nan_dumps")),
                     runner.env)
    iterate = runner.train_iteration

    def guarded_iteration(*args, **kwargs):
      metrics = iterate(*args, **kwargs)
      if guard.watch():
        raise RuntimeError("NaN detected; state dumped (see nan_dumps/).")
      return metrics

    runner.train_iteration = guarded_iteration

  dump_yaml(os.path.join(log_dir, "agent_cfg.yaml"), dataclasses.asdict(cfg))

  if cfg.resume:
    ckpt = resolve_latest_checkpoint(log_dir)
    if ckpt:
      print(f"[train] resuming from {ckpt}", flush=True)
      runner.load(ckpt)
    else:
      print(f"[train] --agent.resume: no checkpoint in {log_dir}; starting fresh", flush=True)

  profile_iters = int(get_flag(overrides, "profile") or "0")
  if profile_iters > 0:
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
      activities.append(ProfilerActivity.CUDA)
    print(f"[train] profiling first {profile_iters} iters → {trace_dir}", flush=True)
    with profile(activities=activities) as prof:
      runner.learn(profile_iters)
    trace = os.path.join(trace_dir, f"trace_it{runner.iteration}.json")
    t0 = time.perf_counter()
    prof.export_chrome_trace(trace)
    print(f"[train] wrote {trace}: {os.path.getsize(trace) / 2**20:.1f} MiB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runner.learn(cfg.max_iterations - profile_iters)
  else:
    runner.learn(cfg.max_iterations)
  runner.save(os.path.join(log_dir, f"model_{runner.iteration}.pt"))
  if runner.last_metrics is not None:
    with open(os.path.join(log_dir, "final_metrics.json"), "w") as f:
      json.dump({"iteration": runner.iteration, **runner.last_metrics}, f)
  return runner


def main() -> None:
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.scripts.cli import format_help, parse_args

  tasks.load_entry_points()
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
      usage=f"usage: train {task} [--env.<field> v] [--agent.<field> v] [--log_dir d] "
      "[--profile n] [--enable_nan_guard] [--motion-file p.npz] "
      "[--registry-name artifact[:alias]]",
    ))
    sys.exit(0)
  run_train(task, overrides)


if __name__ == "__main__":
  main()
