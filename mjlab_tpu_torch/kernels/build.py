"""Build the port's CUDA sources with nvcc into plain-C shared libraries and
load them with ctypes.

Each source `csrc/<name>.cu` becomes `build/kernels/lib<name>-<hash>.so` at
the root of the checkout (listed in .gitignore); the hash of the source and
the flags names the file, so a changed source is rebuilt and an unchanged
one is loaded as it is. `build_all()` starts one nvcc per source at once.
Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("chol", "newton_dir")
NVCC_FLAGS = (
  "-gencode=arch=compute_90a,code=sm_90a",
  "-std=c++17",
  "-O3",
  "-shared",
  "-Xcompiler",
  "-fPIC",
  "--ptxas-options=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name → nvcc's output (ptxas register use)


def _nvcc() -> str:
  for cand in (
    shutil.which("nvcc"),
    os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
  ):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def _target(name: str) -> tuple[Path, list[str]]:
  src = CSRC / f"{name}.cu"
  deps = sorted(CSRC.glob("*.cuh"))
  h = hashlib.sha256()
  for p in (src, *deps):
    h.update(p.read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
  cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
  return out, cmd


def _start(name: str):
  out, cmd = _target(name)
  if out.exists():
    return out, None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  cmd[cmd.index(str(out))] = str(tmp)
  proc = subprocess.Popen(
    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
  )
  return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> None:
  if pending is not None:
    proc, tmp = pending
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
  _libs[name] = ctypes.CDLL(str(out))


def build_all() -> dict[str, ctypes.CDLL]:
  """Build (in parallel) and load every kernel library."""
  with _lock:
    todo = [n for n in SOURCES if n not in _libs]
    started = [(n, *_start(n)) for n in todo]
    for name, out, pending in started:
      _finish(name, out, pending)
    return dict(_libs)


def library(name: str) -> ctypes.CDLL:
  """The loaded library of csrc/<name>.cu, built at first use."""
  if name not in _libs:
    build_all()
  return _libs[name]
