"""Filesystem helpers: checkpoint resolution and the yaml dump (port of
mjlab_tpu/utils/os.py; reference utils/os.py:52-84).

The port's checkpoints are `model_<iteration>.pt` files, so the default
pattern full-matches `model_(\\d+)\\.pt`: neither the TorchScript export
`model_<iteration>_policy.pt` beside it nor the temporary file of a save in
progress (`OnPolicyRunner.save` writes `.model_<iteration>.pt.tmp`, then
renames it) can shadow a checkpoint.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

CHECKPOINT_REGEX = r"model_(\d+)\.pt"


def resolve_checkpoint(
  run_dir: str | Path,
  run_regex: str = ".*",
  ckpt_regex: str = CHECKPOINT_REGEX,
) -> str | None:
  """The newest checkpoint (highest iteration) in `run_dir` itself, else in
  the newest (last by name) subdirectory that full-matches `run_regex` and
  holds one; None when there is none. The JAX package's search order."""
  root = Path(run_dir)
  if not root.is_dir():
    return None

  def newest_in(run: Path) -> Path | None:
    best_iter, best = -1, None
    for f in run.iterdir():
      m = re.fullmatch(ckpt_regex, f.name)
      if m and int(m.group(1)) > best_iter:
        best_iter, best = int(m.group(1)), f
    return best

  best = newest_in(root)
  if best is not None:
    return str(best)
  runs = sorted(d for d in root.iterdir() if d.is_dir() and re.fullmatch(run_regex, d.name))
  for run in reversed(runs):
    best = newest_in(run)
    if best is not None:
      return str(best)
  return None


def resolve_latest_checkpoint(log_root: str | Path) -> str | None:
  return resolve_checkpoint(log_root)


def dump_yaml(path: str | Path, data: dict) -> None:
  import yaml

  os.makedirs(Path(path).parent, exist_ok=True)
  with open(path, "w") as f:
    yaml.safe_dump(data, f)
