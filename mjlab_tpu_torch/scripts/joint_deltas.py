"""Policy analysis: per-joint statistics of the commanded position targets
and their per-step changes over a rollout (port of
mjlab_tpu/scripts/joint_deltas.py).

  python -m mjlab_tpu_torch.scripts.joint_deltas <Task-ID> \
      [--checkpoint path] [--steps 200] [--num_envs 16] [--agent.device cpu]

Runs on CUDA unless `--agent.device cpu`. Without a checkpoint the policy
acts zero. The targets (the joint action term's processed actions after
each step) are stacked on the device and pulled once; the table is the JAX
script's. `--env.*`, `--agent.*` and the motion flags are read as play
reads them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

_FLAGS = ("checkpoint", "run_path", "steps", "num_envs", "motion_file", "registry_name")
HEADERS = ["Joint", "Mean", "Std", "Min", "Max", "|Δ| mean", "|Δ| max"]


def joint_delta_rows(t: np.ndarray, joint_names: list) -> list[list[str]]:
  """The table's rows from the targets `t` (T, B, A): per joint, mean, std,
  min and max of the targets and the mean and max of |Δ| between steps."""
  deltas = np.abs(np.diff(t, axis=0))
  rows = []
  for j, name in enumerate(joint_names or range(t.shape[-1])):
    rows.append([
      name,
      f"{t[..., j].mean():+.3f}",
      f"{t[..., j].std():.3f}",
      f"{t[..., j].min():+.3f}",
      f"{t[..., j].max():+.3f}",
      f"{deltas[..., j].mean():.4f}",
      f"{deltas[..., j].max():.4f}",
    ])
  return rows


def run_joint_deltas(task: str, overrides: dict[str, str]) -> str:
  """Roll the policy out and print the table; returns it."""
  from mjlab_tpu_torch.scripts.cli import check_flags
  from mjlab_tpu_torch.scripts.play import load_play_env, make_policy
  from mjlab_tpu_torch.utils.logging import render_table

  check_flags(overrides, _FLAGS, "joint_deltas")
  steps = int(overrides.get("steps", "200"))
  num_envs = int(overrides.get("num_envs", "16"))
  env, agent_cfg = load_play_env(task, {**overrides, "num_envs": str(num_envs)}, play=False)
  policy = make_policy("trained" if "checkpoint" in overrides else "zero", env, agent_cfg,
                       overrides)
  term = env.action_manager.get_term("joint_pos")
  joint_names = list(getattr(term, "_actuator_names", []))

  obs, _ = env.reset(seed=0)
  targets = []
  for _ in range(steps):
    obs, *_ = env.step(policy(obs).to(env.dtype))
    targets.append(term.processed_actions.clone())
  t = torch.stack(targets).cpu().numpy()  # (T, B, A), one pull
  table = render_table(f"Joint position targets over {steps} steps × {num_envs} envs",
                       HEADERS, joint_delta_rows(t, joint_names))
  print(table)
  return table


def main() -> None:
  from mjlab_tpu_torch.scripts.cli import parse_args

  positionals, overrides = parse_args(sys.argv[1:])
  if not positionals:
    print("usage: joint_deltas <Task-ID> [--checkpoint ..] [--steps N]")
    sys.exit(1)
  run_joint_deltas(positionals[0], overrides)


if __name__ == "__main__":
  main()
