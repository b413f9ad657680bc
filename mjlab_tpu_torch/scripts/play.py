"""Policy playback and evaluation, headless (port of
mjlab_tpu/scripts/play.py).

Usage:
  python -m mjlab_tpu_torch.scripts.play Mjlab-Velocity-Flat-Unitree-G1 \
      [--checkpoint logs/g1_velocity/model_100.pt | --run_path name[:alias]] \
      [--policy zero|random|trained] [--num_envs 1] [--steps 1000] [--seed 0] \
      [--motion-file m.npz | --registry-name name[:alias]] [--env.<field> v] \
      [--agent.<field> v]

Runs on CUDA unless `--agent.device cpu`. The env takes the play overrides
(an effectively endless episode, no observation corruption, no pushes); the
policy is the trained one from `--checkpoint`, from a checkpoint of the
local artifact registry (`--run_path`) or else the newest under
logs/<experiment_name>, or zero or random actions (`--policy`; trained when
a checkpoint is given, else zero). The rewards are summed on the device and
pulled once, at the end, for the summary line. The viewers (`--viewer
native|viser`) and `--video` need `mujoco` and are not ported; each raises
NotImplementedError.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

_FLAGS = ("checkpoint", "run_path", "policy", "num_envs", "steps", "seed", "motion_file",
          "registry_name", "viewer", "video")


def apply_play_overrides(env_cfg) -> None:
  """Eval-friendly config surgery (reference play.py:47-91). An episode of
  1e6 s is 5e7 steps at 50 Hz, inside the int32 episode counter. A
  generator terrain shrinks to at most 3 x 3 tiles without the curriculum,
  as in the JAX function; the env regenerates it when it builds its
  scene."""
  env_cfg.episode_length_s = 1.0e6
  for group in env_cfg.observations.values():
    group.enable_corruption = False
  env_cfg.events.pop("push_robot", None)
  terrain = env_cfg.scene.terrain
  if terrain is not None and terrain.terrain_generator is not None:
    gen = terrain.terrain_generator
    gen.num_rows = min(gen.num_rows, 3)
    gen.num_cols = min(gen.num_cols, 3)
    gen.curriculum = False


@dataclass
class PlayResult:
  env: object
  policy: object  # obs dict -> actions on the env's device
  obs: dict  # the observations after the last step
  mean_reward: float  # per env and step
  base_z: np.ndarray  # (num_envs,) at the end
  seconds: float  # the rollout's wall time, the final pull included


def make_policy(kind: str, env, agent_cfg, overrides: dict[str, str]):
  """The play policy: `trained` (the checkpoint's inference policy),
  `random` (N(0, 0.1²) from a generator seeded with 0) or `zero`."""
  from mjlab_tpu_torch.rl.runner import OnPolicyRunner
  from mjlab_tpu_torch.scripts.cli import get_flag

  B, act_dim = env.num_envs, env.action_manager.total_action_dim
  if kind == "trained":
    ckpt = overrides.get("checkpoint")
    run_path = get_flag(overrides, "run_path")
    if ckpt is None and run_path:
      from mjlab_tpu_torch.utils.artifacts import get_checkpoint_path

      ckpt_path, was_cached = get_checkpoint_path("logs", run_path)
      ckpt = str(ckpt_path)
      print(f"[play] registry checkpoint {run_path} -> {ckpt} (cached={was_cached})")
    if ckpt is None:
      from mjlab_tpu_torch.utils.os import resolve_latest_checkpoint

      ckpt = resolve_latest_checkpoint(f"logs/{agent_cfg.experiment_name}")
      if ckpt is None:
        raise FileNotFoundError("No checkpoint found; pass --checkpoint")
    runner = OnPolicyRunner(env, agent_cfg)
    runner.load(ckpt)
    return runner.get_inference_policy()
  if kind == "random":
    gen = torch.Generator(device=env.device).manual_seed(0)
    return lambda obs: 0.1 * torch.randn((B, act_dim), generator=gen, device=env.device)
  if kind == "zero":
    return lambda obs: torch.zeros((B, act_dim), device=env.device)
  raise ValueError(f"--policy {kind}: expected zero, random or trained")


def load_play_env(task: str, overrides: dict[str, str], play: bool = True):
  """The task's env and runner cfg with the CLI's overrides (`--num_envs`,
  default 1; `--env.*`, `--agent.*`, the motion flags), the play overrides
  when `play`, on `--agent.device` (CUDA by default)."""
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.scripts.cli import apply_overrides, get_flag

  env_cfg = tasks.load_env_cfg(task)
  agent_cfg = tasks.load_rl_cfg(task)
  apply_overrides(agent_cfg, {k[6:]: v for k, v in overrides.items() if k.startswith("agent.")})
  if play:
    apply_play_overrides(env_cfg)
  env_cfg.scene.num_envs = int(overrides.get("num_envs", "1"))
  apply_overrides(env_cfg, {k[4:]: v for k, v in overrides.items() if k.startswith("env.")})
  motion = get_flag(overrides, "motion_file")
  registry_name = get_flag(overrides, "registry_name")
  if not motion and registry_name:
    from mjlab_tpu_torch.utils.artifacts import resolve_motion_file

    motion = resolve_motion_file(registry_name)
  if motion:
    apply_overrides(env_cfg, {"commands.motion.motion_file": motion})
  return ManagerBasedRlEnv(env_cfg, device=agent_cfg.device), agent_cfg


def run_play(task: str, overrides: dict[str, str]) -> PlayResult:
  from mjlab_tpu_torch.scripts.cli import check_flags

  check_flags(overrides, _FLAGS, "play")
  viewer = overrides.get("viewer", "none")
  if viewer != "none":
    raise NotImplementedError(f"--viewer {viewer} is not supported by mjlab_tpu_torch's play "
                              "(it needs mujoco)")
  if "video" in overrides:
    raise NotImplementedError("--video is not supported by mjlab_tpu_torch's play "
                              "(it needs mujoco's renderer)")
  env, agent_cfg = load_play_env(task, overrides)
  kind = overrides.get("policy", "trained" if "checkpoint" in overrides else "zero")
  policy = make_policy(kind, env, agent_cfg, overrides)
  steps = int(overrides.get("steps", "1000"))

  obs, _ = env.reset(seed=int(overrides.get("seed", "0")))
  total = torch.zeros(env.num_envs, dtype=env.dtype, device=env.device)
  t0 = time.perf_counter()
  for _ in range(steps):
    obs, rew, *_ = env.step(policy(obs).to(env.dtype))
    total = total + rew
  # One pull: the mean summed reward, then each env's base height.
  host = torch.cat([total.mean().reshape(1), env.data.qpos[:, 2]]).cpu().numpy()
  seconds = time.perf_counter() - t0
  mean_reward = float(host[0]) / steps
  print(f"[play] {task}: {steps} steps, mean reward/step {mean_reward:.4f}, base z "
        f"{host[1:].round(3)}")
  return PlayResult(env, policy, obs, mean_reward, host[1:], seconds)


def main() -> None:
  from mjlab_tpu_torch import tasks
  from mjlab_tpu_torch.scripts.cli import format_help, parse_args

  tasks.load_entry_points()
  positionals, overrides = parse_args(sys.argv[1:])
  if not positionals:
    print("usage: play <Task-ID> [--checkpoint ..] [--policy zero|random|trained]")
    sys.exit(1)
  task = positionals[0]
  if "help" in overrides:
    print(format_help(
      {"env": tasks.load_env_cfg(task)},
      usage=f"usage: play {task} [--env.<field> v] [--agent.<field> v] [--checkpoint ..] "
      "[--run_path name[:alias]] [--policy zero|random|trained] [--num_envs n] [--steps n] "
      "[--seed s] [--motion-file p.npz] [--registry-name artifact[:alias]]",
    ))
    sys.exit(0)
  run_play(task, overrides)


if __name__ == "__main__":
  main()
