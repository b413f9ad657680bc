"""Minimal typed-dataclass CLI (tyro-style) for the entry-point scripts: a
copy of mjlab_tpu/scripts/cli.py, so that the port imports nothing of the
JAX package.

The reference drives its scripts with tyro (scripts/train.py:127-156):
positional task id + dotted flags overriding any nested config field. This
module implements the subset the scripts use: `--a.b.c value` paths
resolved through nested dataclasses and dicts, with type coercion from the
current value.
"""

from __future__ import annotations

import ast
from typing import Any, Sequence


def _coerce(current: Any, text: str) -> Any:
  if isinstance(current, bool):
    return text.lower() in ("1", "true", "yes", "on")
  if isinstance(current, int) and not isinstance(current, bool):
    return int(text)
  if isinstance(current, float):
    return float(text)
  if isinstance(current, (tuple, list)):
    value = ast.literal_eval(text)
    return type(current)(value)
  if current is None:
    try:
      return ast.literal_eval(text)
    except (ValueError, SyntaxError):
      return text
  return text


def apply_overrides(obj: Any, overrides: dict[str, str]) -> None:
  """Apply {"a.b.c": "value"} overrides in place on nested objects."""
  for path, text in overrides.items():
    parts = path.replace("-", "_").split(".")
    target = obj
    for p in parts[:-1]:
      if isinstance(target, dict):
        target = target[p]
      else:
        target = getattr(target, p)
    leaf = parts[-1]
    current = target[leaf] if isinstance(target, dict) else getattr(target, leaf)
    value = _coerce(current, text)
    if isinstance(target, dict):
      target[leaf] = value
    else:
      setattr(target, leaf, value)


def get_flag(overrides: dict[str, str], name: str) -> str | None:
  """The value of `--name`, spelled with `_` or `-`; None when absent."""
  return overrides.get(name) or overrides.get(name.replace("_", "-"))


def check_flags(overrides: dict[str, str], known: tuple[str, ...], script: str,
                unported: tuple[str, ...] = ()) -> None:
  """Refuse a flag `script` does not take: NotImplementedError for one of
  `unported` (a flag of the JAX script that the port lacks), ValueError for
  one that is neither `known` nor an `--env.*` / `--agent.*` field. A flag
  is matched spelled with `_` or `-`."""
  for key in overrides:
    name = key.replace("-", "_")
    if name in unported:
      raise NotImplementedError(f"--{key} is not supported by mjlab_tpu_torch's {script}")
    if not key.startswith(("env.", "agent.")) and name not in known:
      raise ValueError(f"unknown flag --{key}")


def parse_args(argv: Sequence[str]) -> tuple[list[str], dict[str, str]]:
  """Split argv into positionals and --dotted.path=value / --flag value pairs."""
  positionals: list[str] = []
  overrides: dict[str, str] = {}
  i = 0
  while i < len(argv):
    arg = argv[i]
    if arg.startswith("--"):
      key = arg[2:]
      if "=" in key:
        key, value = key.split("=", 1)
      else:
        if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
          value = "true"  # bare flag
        else:
          value = argv[i + 1]
          i += 1
      overrides[key] = value
    else:
      positionals.append(arg)
    i += 1
  return positionals, overrides


# ---------------------------------------------------------------------------
# Generated --help for nested dataclass configs (reference tyro behavior,
# scripts/train.py:127-156: every nested field is an overridable flag).
# ---------------------------------------------------------------------------


def _is_leaf(value: Any) -> bool:
  import dataclasses

  if dataclasses.is_dataclass(value) and not isinstance(value, type):
    return False
  if isinstance(value, dict):
    return False
  return True


def iter_leaves(obj: Any, prefix: str = ""):
  """Yield (dotted_path, value) for every overridable field of a nested
  dataclass/dict config, in declaration order."""
  import dataclasses

  if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    items = [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
  elif isinstance(obj, dict):
    items = list(obj.items())
  else:
    return
  for name, value in items:
    if callable(value) or isinstance(value, type):
      continue  # term functions / class_type handles are not CLI-settable
    path = f"{prefix}.{name}" if prefix else str(name)
    if _is_leaf(value):
      yield path, value
    else:
      yield from iter_leaves(value, path)


def format_help(sections: dict[str, Any], usage: str) -> str:
  """Render a tyro-style flag listing: one line per overridable leaf with
  its type and current (default) value, grouped by section prefix."""
  lines = [usage, ""]
  for section, cfg in sections.items():
    rows = []
    for path, value in iter_leaves(cfg, section):
      tname = type(value).__name__ if value is not None else "Any"
      sval = repr(value)
      if len(sval) > 48:
        sval = sval[:45] + "..."
      rows.append((f"--{path}", tname, sval))
    if not rows:
      continue
    lines.append(f"{section} options:")
    width = min(max(len(r[0]) for r in rows), 52)
    for flag, tname, sval in rows:
      lines.append(f"  {flag:<{width}}  {tname:<8} (default: {sval})")
    lines.append("")
  return "\n".join(lines)
