"""Check csrc/newton_iter.cu's logic on the CPU: build it with g++ against
cuda_emu.h (a host emulation of the warp primitives it uses) and hold its
three entry points against their plain versions (kernels/newton.py) on the
seeded problems of tests/test_torch_newton_iter.py. Run from the root of
the repo:

    python tools/warp_emu/run.py

It builds build/warp_emu/libnewton_iter_emu.so (a minute at most) and prints
each problem's largest relative error per output; float64 agrees to ~1e-15.
Only nvcc on the card says whether the source compiles there and how fast
it runs.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from mjlab_tpu_torch.kernels import newton  # noqa: E402
from tests.test_torch_newton_iter import LS_STEPS, PLAIN, outputs, problem  # noqa: E402

OUT = ROOT / "build" / "warp_emu"


def build() -> ctypes.CDLL:
  src = (ROOT / "mjlab_tpu_torch" / "csrc" / "newton_iter.cu").read_text()
  src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
  src = src.replace("extern __shared__ __align__(16) unsigned char smem[];",
                    "unsigned char* smem = emu::smem();")
  src, k = re.subn(r"newton_iter_kernel<T, kMode><<<a\.batch, 32, bytes, stream>>>\(a\);",
                   "emu::launch(a.batch, bytes, [&] { newton_iter_kernel<T, kMode>(a); });", src)
  if k != 1:
    raise RuntimeError("the kernel's launch line changed: update the emulation's rewrite")
  OUT.mkdir(parents=True, exist_ok=True)
  (OUT / "newton_iter_emu.cpp").write_text(src)
  lib = OUT / "libnewton_iter_emu.so"
  subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                  "-Wno-unknown-pragmas", f"-I{Path(__file__).parent}",
                  str(OUT / "newton_iter_emu.cpp"), "-o", str(lib)], check=True)
  return ctypes.CDLL(str(lib))


def emulated(lib: ctypes.CDLL) -> dict:
  """The three entry points through the emulated library, with the
  wrappers' arguments (kernels/newton.py `_launch`)."""
  suffix = {torch.float32: "f32", torch.float64: "f64"}

  def call(name, rows, x, p, outs, improved, count, flag):
    B, n = rows.qM.shape[:2]
    m = rows.J.shape[1]
    lay = rows.layout
    S, nb = (0, 0) if lay is None else (lay.table.shape[0], lay.nb)
    scratch = torch.full((B, newton.scratch_elems(m)), float("nan"), dtype=rows.qM.dtype)
    ptrs = [rows.qM, rows.J, rows.D, rows.aref, rows.fl, rows.kind,
            None if lay is None else lay.table, rows.mu0, rows.a0, x, p, *outs, improved,
            scratch]
    f = getattr(lib, f"{name}_{suffix[rows.qM.dtype]}")
    f.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = f(*[None if t is None else t.data_ptr() for t in ptrs], B, n, m, S, nb, count, flag,
           None)
    if rc != 0:
      raise RuntimeError(f"{name}: error {rc}")

  def gradient(rows, x, forces=False):
    vec, per_row = torch.empty_like(x), torch.empty_like(rows.D)
    cone = None
    if not forces and rows.layout is not None:
      cone = torch.empty((x.shape[0], rows.layout.nb), dtype=x.dtype)
    call("newton_gradient", rows, x, None, (vec, per_row, cone), None, 0, int(forces))
    return (per_row, vec) if forces else (vec, per_row, cone)

  def linesearch(rows, x, p, iterations, safeguard):
    x_out, alpha = torch.empty_like(x), torch.empty(x.shape[:1], dtype=x.dtype)
    improved = torch.zeros(x.shape[:1], dtype=torch.bool)
    call("newton_linesearch", rows, x, p, (x_out, alpha, None), improved, iterations,
         int(safeguard))
    return x_out, alpha, improved

  def cost(rows, X):
    out = torch.empty(X.shape[:2], dtype=X.dtype)
    call("constraint_cost", rows, X, None, (out, None, None), None, X.shape[1], 0)
    return out

  return {"gradient": gradient, "linesearch": linesearch, "cost": cost}


CASES = {
  "pyramidal": ((0, 3, 7, 20), {}),
  "equality and friction loss, nv 35": ((1, 3, 35, 60), dict(ne=4, nf=5)),
  "cone dims 3, 4, 6": ((2, 4, 12, 30), dict(ne=2, nf=3, cds=(3, 3, 4, 6))),
  "active counts 127-129 (the cap)": ((3, 3, 35, 300), dict(counts=[127, 128, 129])),
  "every row, nv 64": ((4, 2, 64, 131), dict(active=1.0)),
  "cone rows past the cap": ((5, 2, 33, 5), dict(cds=(6,) * 30)),
  "ragged m 13": ((6, 5, 9, 13), dict(ne=1)),
  "no row active": ((7, 3, 11, 40), dict(ne=2, nf=2, cds=(3, 4), zero=True)),
  "float32": ((8, 4, 35, 80), dict(ne=3, nf=3, cds=(3, 3, 6), dtype=torch.float32)),
}


def main() -> int:
  fn = emulated(build())
  worst = 0.0
  for name, (args, kw) in CASES.items():
    rows, x, p = problem(*args, **kw)
    got, want = outputs(rows, x, p, fn), outputs(rows, x, p, PLAIN)
    errs = {}
    for k, g in got.items():
      if k.startswith("improved"):
        errs[k] = int((g != want[k]).sum())
        continue
      g, w = g.double(), want[k].double()
      if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"{name}: {k}'s NaN pattern")
      ok = ~torch.isnan(w)
      errs[k] = ((g - w)[ok].abs().max() / w[ok].abs().max().clamp_min(1.0)).item() if ok.any() else 0.0
      if rows.qM.dtype == torch.float64:
        worst = max(worst, errs[k])
    print(f"{name}: " + ", ".join(f"{k} {v:.1e}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in errs.items()))
  print(f"float64 largest relative error {worst:.1e} ({LS_STEPS} linesearch steps)")
  return 0 if worst <= 1e-12 else 1


if __name__ == "__main__":
  sys.exit(main())
