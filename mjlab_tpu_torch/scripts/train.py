"""Training entry point of the port (mjlab_tpu/scripts/train.py on one GPU).

Usage:
  python -m mjlab_tpu_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \
      --env.scene.num_envs 4096 --agent.max_iterations 1000 [--log_dir d] \
      [--agent.save_interval 50] [--agent.resume true] [--enable_nan_guard] \
      [--profile n] [--motion-file m.npz | --registry-name name[:alias]] [--mesh auto]

  python -m torch.distributed.run --nproc_per_node N -m mjlab_tpu_torch.scripts.train \
      Mjlab-Velocity-Flat-Unitree-G1 --env.scene.num_envs 16384 ...

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

- Under `torch.distributed.run` the env batch is sharded over the ranks
  (env-sharded data parallelism, `mjlab_tpu_torch.distributed`): each rank
  runs `num_envs / world_size` envs on cuda:LOCAL_RANK (ranks beyond the
  cards share them, through gloo) and the learner is replicated; the run
  computes what one process with all the envs computes. `--mesh auto` (the
  default) shards over the world size, `--mesh off` runs unsharded (and
  raises under more than one rank), `--mesh n` must equal the world size; a
  `num_envs` the shards do not divide raises. Only rank 0 writes the log
  dir.

The JAX script's video flags (`--video`, `--video_interval`) are not
ported; each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

_UNPORTED = ("video", "video_interval")
_FLAGS = ("log_dir", "motion_file", "registry_name", "enable_nan_guard", "profile", "mesh")


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


def mesh_shards(mesh: str | None, num_envs: int, world: int) -> int | None:
  """The shards of the env batch that `--mesh` asks for in a process group
  of `world` ranks: None for an unsharded run. `auto` (the default) is the
  world size, `off` unsharded (refused under more than one rank), a number
  must equal the world size; the shards must divide `num_envs`."""
  mesh = (mesh or "auto").lower()
  if mesh in ("off", "false", "0"):
    if world > 1:
      raise ValueError(f"--mesh off under {world} ranks: each rank would run every env")
    return None
  n = world if mesh in ("auto", "true") else int(mesh)
  if n != world:
    raise ValueError(f"--mesh {n} does not match the world size {world} "
                     f"(launch with torch.distributed.run --nproc_per_node {n})")
  if num_envs % n:
    raise ValueError(f"num_envs={num_envs} not divisible by --mesh {n}; env-axis "
                     "sharding needs equal shards per rank")
  return n


def build_runner(task: str, overrides: dict[str, str], device=None):
  """The task's env and PPO runner, with the CLI's overrides
  ({"env.scene.num_envs": "4096", "agent.seed": "1", "log_dir": ...,
  "motion_file": ..., "mesh": ...}), on `device` (else the runner cfg's
  device, CUDA by default). Under torch.distributed.run it joins the
  process group and builds this rank's share of the envs (`--mesh`) on its
  device (cuda:LOCAL_RANK, or the CPU where asked)."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.distributed import EnvShard, multihost
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.cli import apply_overrides, get_flag

  env_over, agent_over = _split(overrides)
  env_cfg = tasks.load_env_cfg(task)
  if "commands.motion.motion_file" in env_over and "motion" not in (env_cfg.commands or {}):
    raise ValueError(f"--motion-file / --registry-name: task {task} has no motion command")
  agent_cfg = tasks.load_rl_cfg(task)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  log_dir = overrides.get("log_dir", os.path.join("logs", agent_cfg.experiment_name))
  device = str(device or agent_cfg.device)
  grouped = multihost.initialize_multihost(device=device)
  total = env_cfg.scene.num_envs
  shards = mesh_shards(get_flag(overrides, "mesh"), total, multihost.process_count())
  shard = None
  if grouped and shards is not None:
    n = total // shards
    shard = EnvShard(multihost.global_env_offset(n), n, total)
    env_cfg.scene.num_envs = n
    device = multihost.local_device(device)
    if multihost.is_primary_host():
      print(f"[train] env-sharded data parallelism: {total} envs over {shards} ranks",
            flush=True)
  env = ManagerBasedRlEnv(env_cfg, device=device, shard=shard)
  return OnPolicyRunner(env, agent_cfg, log_dir=log_dir)


def run_train(task: str, overrides: dict[str, str]):
  """Build the runner, resume or guard it as the flags ask, train, save the
  final checkpoint and final_metrics.json. Returns the runner."""
  from mjlab_tpu_torch.scripts.cli import get_flag
  from mjlab_tpu_torch.utils.os import dump_yaml, resolve_latest_checkpoint

  from mjlab_tpu_torch.distributed import multihost

  runner = build_runner(task, overrides)
  log_dir, cfg = runner.log_dir, runner.cfg
  primary = multihost.is_primary_host()
  if primary:
    os.makedirs(log_dir, exist_ok=True)
  print(f"[train] task={task} num_envs={runner.env.num_envs} device={runner.device} "
        f"rank={multihost.process_index()}", flush=True)

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

  if primary:
    dump_yaml(os.path.join(log_dir, "agent_cfg.yaml"), dataclasses.asdict(cfg))

  if cfg.resume:
    ckpt = resolve_latest_checkpoint(log_dir)
    if ckpt:
      print(f"[train] resuming from {ckpt}", flush=True)
      runner.load(ckpt)
    else:
      print(f"[train] --agent.resume: no checkpoint in {log_dir}; starting fresh", flush=True)

  t_learn = time.perf_counter()
  profile_iters = int(get_flag(overrides, "profile") or "0")
  if profile_iters > 0 and primary:
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
  elif profile_iters > 0:
    runner.learn(profile_iters)  # the other ranks pull and save where the primary does
  runner.learn(cfg.max_iterations - max(profile_iters, 0))
  if runner.shard is not None:
    _rank_summary(runner, t_learn)
  runner.save(os.path.join(log_dir, f"model_{runner.iteration}.pt"))
  if runner.last_metrics is not None and primary:
    with open(os.path.join(log_dir, "final_metrics.json"), "w") as f:
      json.dump({"iteration": runner.iteration, **runner.last_metrics}, f)
  return runner


def _rank_summary(runner, t_start: float) -> None:
  """A rank's line of a sharded run: its iterations' time since `t_start`
  (time.perf_counter), its peak device memory, and a digest of its learner
  (equal on every rank: the learner is replicated)."""
  import hashlib

  import torch

  from mjlab_tpu_torch.distributed import multihost
  from mjlab_tpu_torch.rl.runner import runner_state_to_arrays

  if runner.device.type == "cuda":
    torch.cuda.synchronize(runner.device)
  seconds = time.perf_counter() - t_start
  digest = hashlib.sha256()
  for key, value in sorted(runner_state_to_arrays(runner).items()):
    digest.update(key.encode())
    digest.update(value.tobytes())
  memory = (torch.cuda.max_memory_allocated(runner.device) / 1e9
            if runner.device.type == "cuda" else float("nan"))
  iters = runner.cfg.max_iterations
  print(f"[train] rank {multihost.process_index()}: {iters} iterations in {seconds:.2f} s, "
        f"{1e3 * seconds / max(iters, 1):.2f} ms per iteration; peak device memory "
        f"{memory:.3f} GB; learner sha256 {digest.hexdigest()}", flush=True)


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
      "[--registry-name artifact[:alias]] [--mesh auto|off|n]",
    ))
    sys.exit(0)
  run_train(task, overrides)
  import torch.distributed as dist

  if dist.is_available() and dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
  main()
