"""Times this checkout's Newton-direction and Cholesky kernels against
other versions of their sources, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_ab.py DIR [DIR ...] [--cut DIR ...]

Each DIR holds one version's `newton_dir.cu` and `chol_core.cuh`, and
optionally its `chol.cu`: for example a parent commit's
`mjlab_tpu_torch/csrc`, unpacked with `git archive` into a directory that
.gitignore lists. A version is named by its DIR's last component; this
checkout's `mjlab_tpu_torch/csrc` is `this`. Every version is built with
`kernels.build.NVCC_FLAGS` into `build/kernel_ab/`, held against the plain
versions (chip_smoke.KernelCheck's rule) and timed with CUDA events in
turns (the others, this, this, the others in reverse; twice) on the cases
below. A version given with `--cut` is one cut short to split the time
(for example, without the factor): it is timed, not held to the plain
versions. The cases:

- `run`: G1 velocity-flat's Newton inputs (qM, J, the weights at qacc, a
  seeded grad) after 30 env steps of `Simulation.step_fn()` at 4096
  worlds, as phase 3 of chip_smoke.py runs them;
- `m0`, `wzero`: random qM with no rows, and with G1's 1699 rows all of
  weight 0;
- `dense`: random qM, J and weights with every row active (phase 2);
- `ell`: G1 under the elliptic cone after 8 env steps: the entry point
  `newton_direction_cone` on that state's weights and cone blocks;
- `chol`: the three entry points of `chol.cu` on phase 2's inputs (six
  random SPD batches, so that every call reads from HBM), for the versions
  that have a `chol.cu`.

Each line of times names the card and its power limit as nvidia-smi
prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "kernel_ab"
P, I = ctypes.c_void_p, ctypes.c_int


def _build(job: tuple[str, Path]) -> tuple[str, ctypes.CDLL, list[str]]:
  """Builds one source; returns its library and, for G1's f32 Newton
  instances (N 35, regular and cone), ptxas' register and spill lines."""
  from mjlab_tpu_torch.kernels import build

  tag, src = job
  so = OUT / f"lib{tag}.so"
  p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
                     capture_output=True, text=True)
  if p.returncode:
    raise SystemExit(f"kernel_ab: nvcc failed for {src}:\n{p.stdout}{p.stderr}")
  fn, ptxas = "", []
  for line in (p.stdout + p.stderr).splitlines():
    if "Compiling entry function" in line or "Function properties for" in line:
      fn = line
    elif ("registers" in line or "spill" in line) and "IfLi35ELb0ELb" in fn:
      kind = "cone" if "IfLi35ELb0ELb1E" in fn else "regular"
      ptxas.append(f"ptxas {tag} f32 N35 {kind}: {line.split(':', 1)[-1].strip()}")
  return tag, ctypes.CDLL(str(so)), ptxas


def _entry(lib: ctypes.CDLL, name: str, ptrs: int, ints: int):
  f = getattr(lib, name)
  f.argtypes = [P] * ptrs + [I] * ints + [P]
  f.restype = I
  return f


def _check_rc(rc: int, what: str) -> None:
  if rc != 0:
    raise RuntimeError(f"kernel_ab: {what} failed with CUDA error {rc}")


class Version:
  """One version's built libraries and its entry points on CUDA tensors."""

  def __init__(self, name: str, newton: ctypes.CDLL, chol: ctypes.CDLL | None):
    self.name, self.newton_lib, self.chol_lib = name, newton, chol

  def newton(self, qM, J, w, g, Bc=None, layout=None):
    cone = Bc is not None
    suffix = "f32" if g.dtype == torch.float32 else "f64"
    x = torch.empty_like(g)
    (B, n), m = g.shape, J.shape[1]
    st = torch.cuda.current_stream().cuda_stream
    if cone:
      f = _entry(self.newton_lib, f"newton_direction_cone_{suffix}", 7, 5)
      rc = f(qM.data_ptr(), J.data_ptr(), w.data_ptr(), g.data_ptr(), Bc.data_ptr(),
             layout.table.data_ptr(), x.data_ptr(), B, n, m, layout.table.shape[0],
             layout.nb, st)
    else:
      f = _entry(self.newton_lib, f"newton_direction_{suffix}", 5, 3)
      rc = f(qM.data_ptr(), J.data_ptr(), w.data_ptr(), g.data_ptr(), x.data_ptr(), B, n, m, st)
    _check_rc(rc, f"{self.name} newton_direction")
    return x

  def chol(self, op: str, A, b=None):
    """op: factor (A -> L), solve (L, b -> x) or factor_solve (A, b -> x)."""
    (B, n), st = A.shape[:2], torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(A if op == "factor" else b)
    ins = [A] if op == "factor" else [A, b]
    f = _entry(self.chol_lib, f"chol_{op}_f32", len(ins) + 1, 2)
    _check_rc(f(*[t.data_ptr() for t in ins], out.data_ptr(), B, n, st), f"{self.name} chol_{op}")
    return out


def build_versions(dirs: list[Path]) -> list[Version]:
  """The other versions and this one; the sources are built in parallel."""
  OUT.mkdir(parents=True, exist_ok=True)
  named = [(d.name, d) for d in dirs] + [("this", ROOT / "mjlab_tpu_torch" / "csrc")]
  if len({name for name, _ in named}) != len(named):
    raise SystemExit("kernel_ab: the directories' last components must differ, and not be 'this'")
  jobs = [(f"{name}_{src}", d / f"{src}.cu") for name, d in named
          for src in ("newton_dir", "chol") if (d / f"{src}.cu").exists()]
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(jobs)) as ex:
    built = list(ex.map(_build, jobs))
  print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
  libs = {tag: lib for tag, lib, _ in built}
  for _, _, ptxas in built:
    print("\n".join(f"  {line}" for line in ptxas), flush=True)
  return [Version(name, libs[f"{name}_newton_dir"], libs.get(f"{name}_chol"))
          for name, _ in named]


def turns(versions: list) -> list:
  """The others, this, this, the others in reverse; twice: each version
  is timed 4 times, the others around this one."""
  others, this = versions[:-1], versions[-1]
  return (others + [this, this] + others[::-1]) * 2


def g1_state(gen, cone: str, steps: int):
  """G1 velocity-flat at cs.NUM_WORLDS worlds after `steps` env steps of
  keyframe targets plus a seeded 0.1-scaled action, as phase 3 runs it."""
  from mjlab_tpu_torch.assets import g1_velocity_sim_cfg, load_model_npz
  from mjlab_tpu_torch.sim import Simulation

  cfg = g1_velocity_sim_cfg()
  cfg.mujoco.cone = cone
  model = load_model_npz()
  sim = Simulation(cs.NUM_WORLDS, cfg, model)
  key = torch.tensor(model.key_qpos[0], dtype=torch.float32, device="cuda")
  ctrl_ref = key[torch.tensor(model.jnt_qposadr[model.actuator_trnid[:, 0]], device="cuda")]
  qpos = key.expand(cs.NUM_WORLDS, -1).clone()
  qpos[:, 7:] += 0.02 * torch.randn(cs.NUM_WORLDS, model.nq - 7, generator=gen, device="cuda")
  d = sim.make_data().replace(qpos=qpos, ctrl=ctrl_ref.expand(cs.NUM_WORLDS, -1).clone())
  step = sim.step_fn()
  for _ in range(steps):
    d = d.replace(ctrl=ctrl_ref + 0.1 * torch.randn(cs.NUM_WORLDS, model.nu, generator=gen,
                                                    device="cuda"))
    for _ in range(cs.DECIMATION):
      d = step(sim.model, d)
  torch.cuda.synchronize()
  return sim, d


def main(argv: list[str] | None = None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("dirs", nargs="+", type=Path, help="other versions' csrc directories")
  ap.add_argument("--cut", action="append", type=Path, default=[],
                  help="a version cut short: timed, not held to the plain versions")
  args = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print("kernel_ab: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
    return 2
  from mjlab_tpu_torch.kernels import chol
  from mjlab_tpu_torch.physics import solver

  torch.backends.cuda.matmul.allow_tf32 = False
  card = cs.card_line()
  print(card, flush=True)
  versions = build_versions(args.dirs + args.cut)
  cut = {d.name for d in args.cut}
  gen = torch.Generator(device="cuda").manual_seed(0)
  grad = torch.randn(cs.NUM_WORLDS, cs.N, generator=gen, device="cuda")
  checks = cs.KernelCheck()

  def report(what: str, times: dict) -> None:
    print(f"  {what} ms [{card}]: " + "; ".join(
      f"{k} " + " ".join(f"{t:.4f}" for t in ts) for k, ts in times.items()), flush=True)

  def case(what, inputs, layout=None, iters=20):
    cone = layout is not None
    plain = ((lambda *a: chol.newton_direction_cone_plain(*a, layout)) if cone
             else chol.newton_direction_plain)
    x64 = plain(*[a.double() for a in inputs])
    for v in versions:
      if v.name not in cut:
        checks.check(v.name, what, v.newton(*inputs, layout=layout), plain(*inputs), x64)
    times: dict[str, list[float]] = {}
    for v in turns(versions):
      times.setdefault(v.name, []).append(
        cs.time_ms(lambda: v.newton(*inputs, layout=layout), [()], iters=iters))
    report(what, times)

  for kind in ("m0", "wzero"):
    m = 0 if kind == "m0" else cs.NEFC
    case(kind, [cs.spd_batch(gen, cs.NUM_WORLDS, cs.N, torch.float32),
                torch.randn(cs.NUM_WORLDS, m, cs.N, generator=gen, device="cuda"),
                torch.zeros(cs.NUM_WORLDS, m, device="cuda"), grad])
  _, d = g1_state(gen, "pyramidal", 30)
  w = solver.newton_weights(d, d.qacc)
  rows = int((w != 0).sum())
  bnd = cs.bounds(cs.NUM_WORLDS, cs.N, rows=rows)["newton_direction"]
  print(f"run: active rows {rows} (share {rows / w.numel():.4f}); bound {bnd[0]:.5f} ms "
        f"({bnd[1]})", flush=True)
  case("run", [d.qM.contiguous(), d.efc_J.contiguous(), w.contiguous(), grad])
  del d, w
  case("dense", [cs.spd_batch(gen, cs.NUM_WORLDS, cs.N, torch.float32),
                 torch.randn(cs.NUM_WORLDS, cs.NEFC, cs.N, generator=gen, device="cuda")
                 / cs.N**0.5,
                 0.1 + torch.rand(cs.NUM_WORLDS, cs.NEFC, generator=gen, device="cuda"),
                 grad], iters=8)
  torch.cuda.empty_cache()
  sim, d = g1_state(gen, "elliptic", 8)
  layout = sim.tp.dev.con.cone_kernel_layout
  gc = solver.GeneralCost(sim.tp, sim.model, d)
  r = gc.residual(d.qacc)
  w, Bc = gc.row_hess(r), gc.cone_blocks(r)
  slots = (Bc.reshape(cs.NUM_WORLDS, -1, 9) != 0).any(-1).sum(1).float()
  rows = int((w != 0).sum())
  bnd = cs.cone_bound(cs.NUM_WORLDS, cs.N, sim.tp.nefc, rows, 3 * int(slots.sum()), layout.nb)
  print(f"ell: active regular rows {rows}, active cone slots per world "
        f"{slots.mean().item():.2f} (max {int(slots.max())}); bound {bnd[0]:.5f} ms "
        f"({bnd[1]})", flush=True)
  case("ell", [d.qM.contiguous(), d.efc_J.contiguous(), w.contiguous(), grad,
               Bc.contiguous()], layout)
  del sim, d, gc, r, w, Bc
  torch.cuda.empty_cache()

  with_chol = [v for v in versions if v.chol_lib is not None and v.name not in cut]
  sets = []
  for _ in range(cs.HBM_SETS):
    A = cs.spd_batch(gen, cs.NUM_WORLDS, cs.N, torch.float32)
    b = torch.randn(cs.NUM_WORLDS, cs.N, generator=gen, device="cuda")
    sets.append((A, b, chol.chol_factor_plain(A)))
  A, b, L = sets[0]
  A64, b64, L64 = A.double(), b.double(), chol.chol_factor_plain(A.double())
  for v in with_chol:
    checks.check(v.name, "chol_factor", v.chol("factor", A), L, L64)
    checks.check(v.name, "chol_solve", v.chol("solve", L, b), chol.chol_solve_plain(L, b),
                 chol.chol_solve_plain(L.double(), b64))
    checks.check(v.name, "chol_factor_solve", v.chol("factor_solve", A, b),
                 chol.chol_factor_solve_plain(A, b), chol.chol_solve_plain(L64, b64))
  for op in ("factor", "solve", "factor_solve"):
    times: dict[str, list[float]] = {}
    for v in turns(with_chol):
      fn = ((lambda A, b, L: v.chol(op, A)) if op == "factor" else
            (lambda A, b, L: v.chol(op, L, b)) if op == "solve" else
            (lambda A, b, L: v.chol(op, A, b)))
      times.setdefault(v.name, []).append(cs.time_ms(fn, sets, iters=4 * cs.HBM_SETS))
    report(f"chol_{op} (HBM)", times)
  return 0


if __name__ == "__main__":
  sys.exit(main())
