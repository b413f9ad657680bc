"""Check csrc/newton_iter.cu's logic on the CPU: build it with g++ against
cuda_emu.h (a host emulation of the warp primitives it uses) and hold its
entry points, called through kernels/newton.py's own launch code, against
their plain versions on the seeded problems of
tests/test_torch_newton_iter.py. Run from the root of the repo:

    python tools/warp_emu/run.py

It builds build/warp_emu/libnewton_iter_emu.so (under a minute) and prints
each problem's largest relative error per output; float64 agrees to ~1e-15.
tests/test_torch_newton_iter_emu.py runs the same checks as tier-1 tests.
Only nvcc on the card says whether the source compiles there and how fast
it runs.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from mjlab_tpu_torch.kernels import newton  # noqa: E402

OUT = ROOT / "build" / "warp_emu"


def build(out: Path = OUT) -> ctypes.CDLL:
  """newton_iter.cu for the host: cuda_emu.h for the CUDA runtime, shared
  memory from the emulator, each launch run block by block."""
  src = (ROOT / "mjlab_tpu_torch" / "csrc" / "newton_iter.cu").read_text()
  src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
  src, k = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
                   "unsigned char* smem = emu::smem();", src)
  if k != 1:
    raise RuntimeError("the kernels' shared memory changed: update the emulation's rewrite")
  src, k = re.subn(r"kernel<<<a\.batch, 32, bytes, stream>>>\(a\);",
                   "emu::launch(a.batch, bytes, [&] { kernel(a); });", src)
  if k != 1:
    raise RuntimeError("the kernels' launch line changed: update the emulation's rewrite")
  out.mkdir(parents=True, exist_ok=True)
  (out / "newton_iter_emu.cpp").write_text(src)
  lib = out / "libnewton_iter_emu.so"
  subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                  "-Wno-unknown-pragmas", f"-I{Path(__file__).parent}",
                  str(out / "newton_iter_emu.cpp"), "-o", str(lib)], check=True)
  return ctypes.CDLL(str(lib))


def entry_points(lib: ctypes.CDLL):
  """A stand-in for kernels/newton.py `_fn` that binds the emulated
  library's entry points."""
  newton.check_library(lib)
  bound = {}

  def fn(key: str):
    if key not in bound:
      bound[key] = newton._bind(lib, key)
    return bound[key]

  return fn


# The wrappers' kernel paths, which take CPU tensors while `newton._fn` is
# the emulated library's.
KERNELS = {"gradient": newton._gradient_kernel, "linesearch": newton._linesearch_kernel,
           "warm_start": newton._warm_start_kernel}


@contextlib.contextmanager
def emulated(lib: ctypes.CDLL):
  """kernels/newton.py's launches go to the emulated library inside."""
  saved = newton._fn
  newton._fn = entry_points(lib)
  try:
    yield KERNELS
  finally:
    newton._fn = saved


def errors(got: dict, want: dict, name: str) -> dict:
  """Each output's largest error relative to max(1, max |want|) (NaN
  patterns equal), and the number of acceptances decided otherwise."""
  errs = {}
  for k, g in got.items():
    if k.startswith("improved"):
      errs[k] = int((g != want[k]).sum())
      continue
    g, w = g.double(), want[k].double()
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
      raise AssertionError(f"{name}: {k}'s NaN pattern")
    ok = ~torch.isnan(w)
    errs[k] = ((g - w)[ok].abs().max() / w[ok].abs().max().clamp_min(1.0)).item() if ok.any() \
      else 0.0
  return errs


def main() -> int:
  from tests.test_torch_newton_iter import EMU_CASES, LS_STEPS, PLAIN, outputs, problem

  worst = 0.0
  with emulated(build()) as fn:
    for name, (args, kw) in EMU_CASES.items():
      prob = problem(*args, **kw)
      errs = errors(outputs(*prob, fn), outputs(*prob, PLAIN), name)
      if prob[0].qM.dtype == torch.float64:
        worst = max([worst] + [v for k, v in errs.items() if not k.startswith("improved")])
      print(f"{name}: " + ", ".join(f"{k} {v:.1e}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in errs.items()))
  print(f"float64 largest relative error {worst:.1e} ({LS_STEPS} linesearch steps)")
  return 0 if worst <= 1e-12 else 1


if __name__ == "__main__":
  sys.exit(main())
