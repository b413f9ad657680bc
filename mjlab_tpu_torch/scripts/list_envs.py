"""List the port's registered Mjlab-* tasks with their env-cfg entry points
(port of mjlab_tpu/scripts/list_envs.py, in its column layout; the port's
registry is a plain dict, without gymnasium).

  python -m mjlab_tpu_torch.scripts.list_envs
"""

from __future__ import annotations

from mjlab_tpu_torch import tasks


def main() -> None:
  ids = tasks.list_tasks()
  if not ids:
    print("No Mjlab-* tasks registered.")
    return
  width = max(len(t) for t in ids) + 2
  print(f"{'Task ID':<{width}} Entry point")
  print("-" * (width + 40))
  for tid in ids:
    print(f"{tid:<{width}} {tasks._REGISTRY[tid]['env']}")


if __name__ == "__main__":
  main()
