"""Artifact registry: named, versioned artifacts on the local filesystem
(port of the local branch of mjlab_tpu/utils/artifacts.py).

The reference resolves motions by `--registry-name` and checkpoints by run
path through the wandb registry, and uploads the exported policy on every
save. The port has the JAX package's local registry only: a directory tree
rooted at MJLAB_REGISTRY_DIR (default ~/.mjlab_registry), laid out as
`<root>/<name>/v<N>/<files>`. Names take an optional `:alias` suffix
(`my-motion:latest`, `:v3`); a bare name means `:latest`, the highest
version. `publish` copies a file or directory in as the next version.
`get_registry` always returns it: the wandb backend needs a network and
`wandb`, and is not ported.

`get_checkpoint_path` differs from the JAX package's on purpose: it resolves
the version first and keys its cache on the artifact's full name and that
version, so a new publish under `:latest` is picked up, and two names that
end alike (`runs/exp1`, `other/exp1`) do not share a cache entry. The JAX
function reads its cache first, keyed on the last path component only
(ROADMAP Queue C).
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path


def _registry_root() -> Path:
  return Path(os.environ.get("MJLAB_REGISTRY_DIR", "~/.mjlab_registry")).expanduser()


class LocalRegistry:
  """Filesystem-backed artifact registry."""

  def __init__(self, root: str | Path | None = None):
    self.root = Path(root) if root else _registry_root()

  def _versions(self, name: str) -> list[tuple[int, Path]]:
    d = self.root / name
    if not d.is_dir():
      return []
    out = []
    for v in d.iterdir():
      m = re.fullmatch(r"v(\d+)", v.name)
      if m and v.is_dir():
        out.append((int(m.group(1)), v))
    return sorted(out)

  def resolve(self, name: str) -> Path:
    """Directory of the named artifact (alias `latest` or `v<N>`)."""
    base, _, alias = name.partition(":")
    alias = alias or "latest"
    versions = self._versions(base)
    if not versions:
      raise FileNotFoundError(
        f"artifact '{base}' not found in local registry {self.root} "
        f"(publish one with LocalRegistry.publish, or pass a direct "
        f"file path instead of a registry name)"
      )
    if alias == "latest":
      return versions[-1][1]
    m = re.fullmatch(r"v(\d+)", alias)
    if m:
      for n, p in versions:
        if n == int(m.group(1)):
          return p
    raise FileNotFoundError(f"artifact '{base}' has no version '{alias}'")

  def publish(self, path: str | Path, name: str) -> Path:
    """Copy a file or directory into the registry as a new version."""
    src = Path(path)
    if not src.exists():
      raise FileNotFoundError(str(src))
    versions = self._versions(name)
    dst = self.root / name / f"v{versions[-1][0] + 1 if versions else 1}"
    dst.mkdir(parents=True, exist_ok=True)
    if src.is_dir():
      shutil.copytree(src, dst / src.name, dirs_exist_ok=True)
    else:
      shutil.copy2(src, dst / src.name)
    return dst


def get_registry() -> LocalRegistry:
  return LocalRegistry()


def resolve_motion_file(registry_name: str) -> str:
  """`--registry-name` → the artifact's motion.npz, or its only .npz file."""
  d = get_registry().resolve(registry_name)
  motion = Path(d) / "motion.npz"
  if motion.exists():
    return str(motion)
  npz = sorted(Path(d).rglob("*.npz"))
  if len(npz) == 1:
    return str(npz[0])
  raise FileNotFoundError(
    f"artifact '{registry_name}' ({d}) does not contain motion.npz "
    f"(found {len(npz)} .npz files)"
  )


def get_checkpoint_path(log_path: str | Path, run_path: str | Path) -> tuple[Path, bool]:
  """The newest `model_<iteration>.pt` of the registry artifact `run_path`,
  copied into the cache `<log_path>/registry_checkpoints/<name>_v<N>` (the
  full name with `/` and `:` made `_`, and the resolved version). Returns
  (checkpoint path, whether it came from the cache)."""
  from mjlab_tpu_torch.utils.os import resolve_checkpoint

  src = get_registry().resolve(str(run_path))
  base = str(run_path).partition(":")[0]
  key = re.sub(r"[^A-Za-z0-9._-]", "_", base.strip("/")) + f"_{src.name}"
  cache_dir = Path(log_path) / "registry_checkpoints" / key
  found = resolve_checkpoint(src)
  if not found:
    raise FileNotFoundError(
      f"no model_<iteration>.pt checkpoint inside artifact '{run_path}' ({src})"
    )
  dst = cache_dir / Path(found).name
  if dst.is_file():
    return dst, True
  cache_dir.mkdir(parents=True, exist_ok=True)
  tmp = cache_dir / f".{dst.name}.tmp"  # a cut copy is never taken for a cached one
  shutil.copy2(found, tmp)
  os.replace(tmp, dst)
  return dst, False
