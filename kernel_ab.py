"""Times this checkout's Newton-direction, Cholesky, PGS and Newton
iteration kernels against other versions of their sources, on one CUDA
card.

Run from the root of a checkout:

    python3 kernel_ab.py DIR [DIR ...] [--cut DIR ...] [--cases newton chol pgs newton_iter
                                                           warm_start]

Each DIR holds one version's sources, any of `newton_dir.cu` (with
`chol_core.cuh`), `chol.cu`, `pgs.cu` and `newton_iter.cu`: for example a
parent commit's `mjlab_tpu_torch/csrc`, unpacked with `git archive` into a
directory that .gitignore lists. A version is named by its DIR's last
component; this checkout's `mjlab_tpu_torch/csrc` is `this`. Every source is
built into `build/kernel_ab/` with `kernels.build.NVCC_FLAGS` (this
checkout's, and a `newton_iter.cu` with the solve's list, with
`kernels.build.flags`, their source's own flags), held
against the plain versions (chip_smoke.KernelCheck's rule) and timed with
CUDA events in turns (the others, this, this, the others in reverse; twice)
on the cases below, each case with the versions that have its source. A
version given with `--cut` is one cut short to split the time (for example,
without the factor): it is timed, not held to the plain versions. `--cases`
picks the groups to run (all five by default): `newton` is run, m0, wzero,
dense and ell, `chol` the Cholesky entries, `pgs` the PGS case,
`newton_iter` the Newton iteration's, `warm_start` the solve's start. The
cases:

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
  that have a `chol.cu`;
- `pgs`: G1 velocity-flat under solver="pgs" after phase 17's warm-up step
  and 10 env steps at 4096 worlds (f32): `pgs_solve` on that state's L,
  J, a0, aref, D, lo and hi, f, u and qfrc held to the plain version. A
  `pgs.cu` whose entry takes b (no `pgs_solve_config`, the form before the
  kernel formed b and Jᵀf) is timed with b = J a0 − aref and qfrc = Jᵀf in
  torch around it, so that every version times the same function;
- `newton_iter`: one Newton iteration's non-direction work, from (x, p) to
  (x', ∇, w, the cone blocks), on the rows of G1 velocity-flat after 30 env
  steps (phase 3b's run), under the elliptic cone after 8 (the safeguard's
  acceptance) and under CG after 8, at 4096 worlds, f32, x = a0 and p its
  Newton direction: a `newton_iter.cu` whose linesearch returns the
  gradient at x' (`newton_iter_scratch_elems`) runs one newton_linesearch
  launch on the solve's list, one without runs newton_linesearch and then
  newton_gradient at x'. Each is held to newton_linesearch_plain followed
  by newton_gradient_plain; each time is printed beside chip_smoke's
  `newton_bounds` "iteration" bound, and the list's one-time build
  (newton_gradient with it and without) is timed too;
- `warm_start`: the solve's start, from (ws, a0) to (x0, ∇, w, the cone
  blocks) with the list of active rows built, on the same three states'
  rows with ws = their qacc_warmstart: a `newton_iter.cu` with a
  `warm_start` entry runs that one launch; one with `constraint_cost` (the
  form before it) runs constraint_cost at (ws, a0), torch.where for x0, and
  newton_gradient at x0 with the list's build, as the solver ran them. Each
  is held to warm_start_plain and timed beside chip_smoke's `newton_bounds`
  "warm_start" bound.

Each line of times names the card and its power limit as nvidia-smi
prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import re
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


SOURCES = ("newton_dir", "chol", "pgs", "newton_iter")
CASES = ("newton", "chol", "pgs", "newton_iter", "warm_start")


def _build(job: tuple[str, Path, tuple[str, ...]]) -> tuple[str, ctypes.CDLL, list[str]]:
  """Builds one source with these flags; returns its library and ptxas'
  register and spill lines for G1's f32 instances (the Newton pair's N 35,
  regular and cone; every f32 instance of a PGS kernel and of the Newton
  iteration's)."""
  from mjlab_tpu_torch.kernels import build

  tag, src, flags = job
  so = OUT / f"lib{tag}.so"
  p = subprocess.run([build._nvcc(), *flags, "-o", str(so), str(src)],
                     capture_output=True, text=True)
  if p.returncode:
    raise SystemExit(f"kernel_ab: nvcc failed for {src}:\n{p.stdout}{p.stderr}")
  fn, ptxas = "", []
  for line in (p.stdout + p.stderr).splitlines():
    if "Compiling entry function" in line or "Function properties for" in line:
      fn = line
    elif "registers" in line or "spill" in line:
      what = line.split(":", 1)[-1].strip()
      if "IfLi35ELb0ELb" in fn:
        kind = "cone" if "IfLi35ELb0ELb1E" in fn else "regular"
        ptxas.append(f"ptxas {tag} f32 N35 {kind}: {what}")
      elif (k := re.search(r"pgs_kernelIfLi(\d+)E", fn)) is not None:
        ptxas.append(f"ptxas {tag} f32 {k.group(1)}: {what}")
      elif (k := re.search(r"(newton_iter_kernelIfLi\d+E\w{0,4}|cost_kernelIf)", fn)):
        ptxas.append(f"ptxas {tag} f32 {k.group(1)}: {what}")
  return tag, ctypes.CDLL(str(so)), ptxas


def _entry(lib: ctypes.CDLL, name: str, ptrs: int, ints: int):
  f = getattr(lib, name)
  f.argtypes = [P] * ptrs + [I] * ints + [P]
  f.restype = I
  return f


def _check_rc(rc: int, what: str) -> None:
  if rc != 0:
    raise RuntimeError(f"kernel_ab: {what} failed with CUDA error {rc}")


def version_sources(d: Path) -> list[str]:
  """The sources of SOURCES that the directory holds (newton_dir.cu only
  with its chol_core.cuh)."""
  return [src for src in SOURCES if (d / f"{src}.cu").exists()
          and (src != "newton_dir" or (d / "chol_core.cuh").exists())]


class Version:
  """One version's built libraries and its entry points on CUDA tensors."""

  def __init__(self, name: str, libs: dict[str, ctypes.CDLL]):
    self.name, self.libs = name, libs
    self.newton_lib, self.chol_lib = libs.get("newton_dir"), libs.get("chol")
    self.pgs_lib = libs.get("pgs")
    self.iter_lib = libs.get("newton_iter")

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

  def pgs(self, L, J, a0, aref, D, lo, hi, iterations):
    """A call of this version's f32 pgs_solve on these inputs into buffers
    allocated here once, so that a timing holds no allocation: it returns
    (f, u, qfrc). An entry that takes b gets b = J a0 − aref, and
    qfrc = Jᵀf, from torch around it."""
    from mjlab_tpu_torch.kernels import pgs

    (B, n), m = a0.shape, J.shape[1]
    st = torch.cuda.current_stream().cuda_stream
    f, u, qfrc = torch.empty_like(D), torch.empty_like(a0), torch.empty_like(a0)
    idx = torch.empty((B, m), dtype=torch.int32, device="cuda")
    S = torch.empty((B, 6, m), device="cuda")
    if hasattr(self.pgs_lib, "pgs_solve_config"):
      ws, ars = pgs.scratch_elems(n, m)
      W, AR = torch.empty((B, ws), device="cuda"), torch.empty((B, ars), device="cuda")
      fn = _entry(self.pgs_lib, "pgs_solve_f32", 14, 6)
      ptrs = [t.data_ptr() for t in (L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx)]

      def call(keep=(W, AR, S, idx)):  # the scratch lives as long as the call
        _check_rc(fn(*ptrs, B, n, m, iterations, ws, ars, st), f"{self.name} pgs_solve")
        return f, u, qfrc

      return call
    W, b = torch.empty_like(J), torch.empty_like(D)
    fn = _entry(self.pgs_lib, "pgs_solve_f32", 11, 4)
    ptrs = [t.data_ptr() for t in (L, J, D, b, lo, hi, f, u, W, S, idx)]

    def passes():  # the two passes over J that the kernel does not make
      torch.sub(torch.matmul(J, a0[..., None])[..., 0], aref, out=b)
      qfrc.copy_((J.transpose(-1, -2) @ f[..., None])[..., 0])

    def call_b(keep=(W, S, idx)):
      torch.sub(torch.matmul(J, a0[..., None])[..., 0], aref, out=b)
      _check_rc(fn(*ptrs, B, n, m, iterations, st), f"{self.name} pgs_solve")
      qfrc.copy_((J.transpose(-1, -2) @ f[..., None])[..., 0])
      return f, u, qfrc

    call_b.passes = passes
    return call_b


def build_versions(dirs: list[Path]) -> list[Version]:
  """The other versions and this one; the sources are built in parallel."""
  OUT.mkdir(parents=True, exist_ok=True)
  named = [(d.name, d) for d in dirs] + [("this", ROOT / "mjlab_tpu_torch" / "csrc")]
  if len({name for name, _ in named}) != len(named):
    raise SystemExit("kernel_ab: the directories' last components must differ, and not be 'this'")
  from mjlab_tpu_torch.kernels import build

  def flags(name: str, d: Path, src: str) -> tuple[str, ...]:
    # A newton_iter.cu with the solve's list builds as this checkout's does.
    if name == "this" or (src == "newton_iter"
                          and "newton_iter_scratch_elems" in (d / f"{src}.cu").read_text()):
      return build.flags(src)
    return build.NVCC_FLAGS

  jobs = [(f"{name}_{src}", d / f"{src}.cu", flags(name, d, src))
          for name, d in named for src in version_sources(d)]
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(jobs)) as ex:
    built = list(ex.map(_build, jobs))
  print(f"built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
  libs = {tag: lib for tag, lib, _ in built}
  for _, _, ptxas in built:
    print("\n".join(f"  {line}" for line in ptxas), flush=True)
  return [Version(name, {src: libs[f"{name}_{src}"] for src in version_sources(d)})
          for name, d in named]


def turns(versions: list) -> list:
  """The others, this, this, the others in reverse; twice: each version
  is timed 4 times, the others around this one."""
  others, this = versions[:-1], versions[-1]
  return (others + [this, this] + others[::-1]) * 2


def g1_state(gen, cone: str, steps: int, solver: str = "newton"):
  """G1 velocity-flat at cs.NUM_WORLDS worlds after `steps` env steps of
  keyframe targets plus a seeded 0.1-scaled action, as phase 3 runs it."""
  from mjlab_tpu_torch.assets import g1_velocity_sim_cfg, load_model_npz
  from mjlab_tpu_torch.sim import Simulation

  cfg = g1_velocity_sim_cfg()
  cfg.mujoco.cone = cone
  cfg.mujoco.solver = solver
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


def solve_scratch_elems(lib: ctypes.CDLL, m: int, mc: int) -> int:
  """Elements per world of a solve's scratch as this version sizes it: (m,
  mc) for a library with the warm start's entry, (0, m, mc) before it,
  when one entry also sized constraint_cost's scratch."""
  f = lib.newton_iter_scratch_elems
  f.restype = I
  if hasattr(lib, "warm_start_f32"):
    f.argtypes = [I, I]
    return f(m, mc)
  f.argtypes = [I, I, I]
  return f(0, m, mc)


def warm_start_call(lib: ctypes.CDLL, rows, ws):
  """One version's start of a solve on these f32 rows, from ws, into buffers
  allocated here once: (call, (x0, cost, grad, w, blocks)). A library with
  a warm_start entry launches it; one without launches constraint_cost at
  (ws, a0), torch.where for x0 and newton_gradient at x0 with the list's
  build. `rows` is this version's own Rows (its list is kept there)."""
  from mjlab_tpu_torch.kernels import newton

  (B, n), m = ws.shape, rows.J.shape[1]
  lay = rows.layout
  S, nb = (0, 0) if lay is None else (lay.table.shape[0], lay.nb)
  st = torch.cuda.current_stream().cuda_stream
  state = newton._state(rows)
  scratch = torch.empty((B, max(solve_scratch_elems(lib, m, newton.cone_rows(lay)), 1)),
                        device="cuda")
  x0, grad = torch.empty_like(ws), torch.empty_like(ws)
  cost = torch.empty((B, 2), device="cuda")
  t = dict(qM=rows.qM, J=rows.J, D=rows.D, aref=rows.aref, fl=rows.fl, kind=rows.kind,
           tab=None if lay is None else lay.table, mu0=rows.mu0, a0=rows.a0, w=state.w,
           blocks=state.blocks, lst=state.lst, counts=state.counts, slots=state.slots,
           scratch=scratch, vec=grad)
  ints = (B, n, m, S, nb)

  def args(**more):
    return [None if (v := {**t, **more}.get(k)) is None else v.data_ptr() for k in newton._PTRS]

  if hasattr(lib, "warm_start_f32"):
    fn = newton._bind(lib, "warm_start_f32")
    ptrs = args(x=ws, xo=x0, alpha=cost)

    def call(keep=(x0, cost, grad, state, scratch)):
      _check_rc(fn(*ptrs, *ints, 0, 0, *state.ext, st), "warm_start")

    return call, (x0, cost, grad, state.w, state.blocks)
  ext = max(m - 128, 0)  # constraint_cost's own list held 128 rows in shared memory
  X = torch.stack([ws, rows.a0], dim=1).contiguous()
  cost_scratch = torch.empty((B, max(2 * ext, 1)), device="cuda")
  cost_fn = newton._bind(lib, "constraint_cost_f32")
  gr_fn = newton._bind(lib, "newton_gradient_f32")
  cost_ptrs = args(x=X, vec=cost, scratch=cost_scratch)
  gr_ptrs = args(x=x0)

  def call_pair(keep=(X, x0, cost, grad, state, scratch, cost_scratch)):
    _check_rc(cost_fn(*cost_ptrs, *ints, 2, 0, ext, 0, st), "constraint_cost")
    torch.where((cost[:, 0] < cost[:, 1])[:, None], ws, rows.a0, out=x0)
    _check_rc(gr_fn(*gr_ptrs, *ints, 0, newton.BUILD, *state.ext, st), "newton_gradient")

  return call_pair, (x0, cost, grad, state.w, state.blocks)


def iteration_call(lib: ctypes.CDLL, rows, x, p, iters: int, safeguard: bool):
  """One version's non-direction work of a Newton iteration on these f32
  rows, from (x, p) to (x', ∇, w, blocks), into buffers allocated here
  once: (call, outputs, first, reused) where `first` is the solve's first
  newton_gradient with the list's build and `reused` the same without it
  (both None for a version without a list). `rows` is this version's own
  Rows (a fused version keeps its list there)."""
  from mjlab_tpu_torch.kernels import newton

  (B, n), m = x.shape, rows.J.shape[1]
  lay = rows.layout
  S, nb = (0, 0) if lay is None else (lay.table.shape[0], lay.nb)
  st = torch.cuda.current_stream().cuda_stream
  base = dict(qM=rows.qM, J=rows.J, D=rows.D, aref=rows.aref, fl=rows.fl, kind=rows.kind,
              tab=None if lay is None else lay.table, mu0=rows.mu0, a0=rows.a0)
  xo, grad = torch.empty_like(x), torch.empty_like(x)
  alpha = torch.empty((B,), device="cuda")
  improved = torch.empty((B,), dtype=torch.bool, device="cuda")

  def ptr(t):
    return None if t is None else t.data_ptr()

  if hasattr(lib, "newton_iter_scratch_elems"):
    state = newton._state(rows)
    # The scratch as this version sizes it (its caps are this checkout's).
    scratch = torch.empty((B, max(solve_scratch_elems(lib, m, newton.cone_rows(lay)), 1)),
                          device="cuda")
    solve = dict(w=state.w, blocks=state.blocks, lst=state.lst, counts=state.counts,
                 slots=state.slots, scratch=scratch)
    ls_fn = newton._bind(lib, "newton_linesearch_f32")
    gr_fn = newton._bind(lib, "newton_gradient_f32")
    g0 = torch.empty_like(x)
    t_ls = {**base, **solve, "x": x, "p": p, "xo": xo, "alpha": alpha, "improved": improved,
            "vec": grad}
    t_gr = {**base, **solve, "x": x, "vec": g0}
    ls_args = [ptr(t_ls.get(k)) for k in newton._PTRS]
    gr_args = [ptr(t_gr.get(k)) for k in newton._PTRS]
    ints = (B, n, m, S, nb)
    flags = newton.WITH_SAFEGUARD if safeguard else 0

    def first(keep=(g0, state, scratch)):
      _check_rc(gr_fn(*gr_args, *ints, 0, newton.BUILD, *state.ext, st), "newton_gradient")

    def reused(keep=(g0, state, scratch)):
      _check_rc(gr_fn(*gr_args, *ints, 0, 0, *state.ext, st), "newton_gradient")

    def call(keep=(xo, grad, alpha, improved, state, scratch)):
      _check_rc(ls_fn(*ls_args, *ints, iters, flags, *state.ext, st), "newton_linesearch")

    first()
    return call, (xo, alpha, improved, grad, state.w, state.blocks), first, reused
  # A version without a list: its newton_linesearch, then its newton_gradient
  # at x' (16 pointers, 7 ints).
  scratch = torch.empty((B, max(5 * max(m - 128, 0), 1)), device="cuda")
  w = torch.empty_like(rows.D)
  blocks = None if lay is None else torch.empty((B, nb), device="cuda")
  ls_fn, gr_fn = _entry(lib, "newton_linesearch_f32", 16, 7), _entry(lib, "newton_gradient_f32", 16, 7)
  b = [ptr(base[k]) for k in ("qM", "J", "D", "aref", "fl", "kind", "tab", "mu0", "a0")]
  ls_args = b + [ptr(x), ptr(p), ptr(xo), ptr(alpha), None, ptr(improved), ptr(scratch),
                 B, n, m, S, nb, iters, int(safeguard), st]
  gr_args = b + [ptr(xo), None, ptr(grad), ptr(w), ptr(blocks), None, ptr(scratch),
                 B, n, m, S, nb, 0, 0, st]

  def call(keep=(xo, grad, alpha, improved, scratch, w, blocks)):
    _check_rc(ls_fn(*ls_args), "newton_linesearch")
    _check_rc(gr_fn(*gr_args), "newton_gradient")

  return call, (xo, alpha, improved, grad, w, blocks), None, None


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("dirs", nargs="+", type=Path, help="other versions' csrc directories")
  ap.add_argument("--cut", action="append", type=Path, default=[],
                  help="a version cut short: timed, not held to the plain versions")
  ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES),
                  help="the groups of cases to run (default: all)")
  return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
  args = parse_args(argv)
  if not torch.cuda.is_available():
    print("kernel_ab: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
    return 2
  from mjlab_tpu_torch.kernels import chol, newton
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

  if "pgs" in args.cases:
    with_pgs = [v for v in versions if v.pgs_lib is not None]
    env, actions = cs.pgs_env()
    for a in actions:
      env.step(a)
    it = env.sim.model.opt.iterations
    ins = cs.pgs_args(env.tp, env.data)
    del env, actions
    gc.collect()
    torch.cuda.empty_cache()
    rows = (ins[4] > 0).sum(1)
    bnd = cs.pgs_bound(ins, it)
    print(f"pgs: active rows per world mean {rows.float().mean().item():.2f}, max "
          f"{int(rows.max())} of {ins[1].shape[1]}; {it} sweeps; bound {bnd[0]:.5f} ms "
          f"({bnd[1]})", flush=True)
    plain = cs.pgs_plain_chunked(ins, it)
    plain64 = cs.pgs_plain_chunked(tuple(a.double() for a in ins), it)
    calls = {v.name: v.pgs(*ins, it) for v in with_pgs}
    for v in with_pgs:
      if v.name not in cut:
        for what, got, p, p64 in zip(("f", "u", "qfrc"), calls[v.name](), plain, plain64):
          checks.check(v.name, f"pgs {what}", got, p, p64)
    del plain, plain64
    torch.cuda.empty_cache()
    times: dict[str, list[float]] = {}
    for v in turns(with_pgs):
      times.setdefault(v.name, []).append(cs.time_ms(calls[v.name], [()], iters=20))
    report("pgs (kernel; b and J^T f in torch for an entry that takes b)", times)
    for name, call in calls.items():
      if hasattr(call, "passes"):
        ms = [cs.time_ms(call.passes, [()], iters=20) for _ in range(2)]
        print(f"  {name}: its two torch passes alone (b = J a0 - aref, J^T f) "
              + " ".join(f"{t:.4f}" for t in ms) + f" ms [{card}]", flush=True)
    rmax = int(rows.max())
    print("  pgs ns per dependent row update: " + "; ".join(
      f"{k} {min(ts) * 1e6 / (it * rmax):.1f}" for k, ts in times.items()), flush=True)
    del ins, calls
    torch.cuda.empty_cache()

  if "newton" in args.cases:
    newton_versions = [v for v in versions if v.newton_lib is not None]

    def case(what, inputs, layout=None, iters=20):
      cone = layout is not None
      plain = ((lambda *a: chol.newton_direction_cone_plain(*a, layout)) if cone
               else chol.newton_direction_plain)
      x64 = plain(*[a.double() for a in inputs])
      for v in newton_versions:
        if v.name not in cut:
          checks.check(v.name, what, v.newton(*inputs, layout=layout), plain(*inputs), x64)
      times: dict[str, list[float]] = {}
      for v in turns(newton_versions):
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
    gcost = newton.Rows.of(sim.tp, d)
    r = gcost.residual(d.qacc)
    w, Bc = gcost.row_hess(r), gcost.cone_blocks(r)
    slots = (Bc.reshape(cs.NUM_WORLDS, -1, 9) != 0).any(-1).sum(1).float()
    rows = int((w != 0).sum())
    bnd = cs.cone_bound(cs.NUM_WORLDS, cs.N, sim.tp.nefc, rows, 3 * int(slots.sum()), layout.nb)
    print(f"ell: active regular rows {rows}, active cone slots per world "
          f"{slots.mean().item():.2f} (max {int(slots.max())}); bound {bnd[0]:.5f} ms "
          f"({bnd[1]})", flush=True)
    case("ell", [d.qM.contiguous(), d.efc_J.contiguous(), w.contiguous(), grad,
                 Bc.contiguous()], layout)
    del sim, d, gcost, r, w, Bc
    torch.cuda.empty_cache()

  if "newton_iter" in args.cases:
    with_iter = [v for v in versions if v.iter_lib is not None]
    for what, cone, solver_, steps, sg in (("run", "pyramidal", "newton", 30, False),
                                          ("ell", "elliptic", "newton", 8, True),
                                          ("cg", "pyramidal", "cg", 8, False)):
      sim, d = g1_state(gen, cone, steps, solver_)
      rows = newton.Rows.of(sim.tp, d)
      x, p = cs.iteration_inputs(rows)
      iters = sim.model.opt.ls_iterations
      del sim, d
      active = int((rows.D != 0).sum())
      bnd = cs.newton_bounds(rows, iters, sg)
      print(f"newton_iter {what}: active rows per world {active / cs.NUM_WORLDS:.2f}; one "
            f"iteration's bound {bnd['iteration'][0]:.5f} ms ({bnd['iteration'][1]}); "
            f"{iters} linesearch steps{', the safeguard' if sg else ''}", flush=True)
      xp, ap, ip = newton.newton_linesearch_plain(rows, x, p, iters, sg)
      plain = (xp, ap, *newton.newton_gradient_plain(rows, xp))
      rows64 = cs.rows_as(rows, torch.float64)
      xp64, ap64, _ = newton.newton_linesearch_plain(rows64, x.double(), p.double(), iters, sg)
      plain64 = (xp64, ap64, *newton.newton_gradient_plain(rows64, xp64))
      calls = {}
      for v in with_iter:
        call, outs, first, reused = iteration_call(v.iter_lib, cs.rows_as(rows, torch.float32),
                                                   x, p, iters, sg)
        calls[v.name] = call
        if v.name in cut:
          continue
        call()
        flips = outs[2] != ip
        if flips.any():
          c_got = rows64.total_cost(outs[0].double())[flips]
          c_plain = rows64.total_cost(xp.double())[flips]
          tie = ((c_got - c_plain).abs() <= 1e-5 * c_plain.abs().clamp_min(1.0)).all().item()
          print(f"  {v.name}: {int(flips.sum())} acceptances decided otherwise (cost ties "
                f"within 1e-5: {tie})", flush=True)
          if not tie:
            raise AssertionError(f"{v.name}: an acceptance differs where costs do not tie")
        keep = ~flips
        for i, label in enumerate(("x'", "alpha", "grad", "w", "blocks")):
          got, want, want64 = (outs[:2] + outs[3:])[i], plain[i], plain64[i]
          if got is None:
            continue
          if i != 1:
            got, want, want64 = got[keep], want[keep], want64[keep]
          checks.check(v.name, f"{what} {label}", got.reshape(got.shape[0], -1),
                       want.reshape(want.shape[0], -1), want64.reshape(want64.shape[0], -1))
        if first is not None:
          ms = [cs.time_ms(f, [()], iters=20) for f in (first, reused, first, reused)]
          print(f"  {v.name}: newton_gradient with the list's build "
                f"{ms[0]:.4f} {ms[2]:.4f} ms, without {ms[1]:.4f} {ms[3]:.4f} ms [{card}]",
                flush=True)
      del plain, plain64, rows64
      times: dict[str, list[float]] = {}
      for v in turns(with_iter):
        times.setdefault(v.name, []).append(cs.time_ms(calls[v.name], [()], iters=20))
      report(f"newton_iter {what}: one iteration's non-direction work (bound "
             f"{bnd['iteration'][0]:.5f} ms)", times)
      del calls, rows, x, p
      gc.collect()
      torch.cuda.empty_cache()

  if "warm_start" in args.cases:
    with_iter = [v for v in versions if v.iter_lib is not None]
    for what, cone, solver_, steps, sg in (("run", "pyramidal", "newton", 30, False),
                                          ("ell", "elliptic", "newton", 8, True),
                                          ("cg", "pyramidal", "cg", 8, False)):
      sim, d = g1_state(gen, cone, steps, solver_)
      rows = newton.Rows.of(sim.tp, d)
      ws = d.qacc_warmstart.contiguous()
      del sim, d
      bnd = cs.newton_bounds(rows, 0, sg)["warm_start"]
      plain = newton.warm_start_plain(rows, ws)
      rows64 = cs.rows_as(rows, torch.float64)
      plain64 = newton.warm_start_plain(rows64, ws.double())
      took = plain[1][:, 0] < plain[1][:, 1]
      print(f"warm_start {what}: active rows per world {int((rows.D != 0).sum()) / cs.NUM_WORLDS:.2f}"
            f"; ws taken in {int(took.sum())} of {cs.NUM_WORLDS} worlds; bound {bnd[0]:.5f} ms "
            f"({bnd[1]})", flush=True)
      calls = {}
      for v in with_iter:
        call, outs = warm_start_call(v.iter_lib, cs.rows_as(rows, torch.float32), ws)
        calls[v.name] = call
        if v.name in cut:
          continue
        call()
        flips = (outs[1][:, 0] < outs[1][:, 1]) != took
        if flips.any():
          c_got = rows64.total_cost(outs[0].double())[flips]
          c_plain = rows64.total_cost(plain[0].double())[flips]
          tie = ((c_got - c_plain).abs() <= 1e-5 * c_plain.abs().clamp_min(1.0)).all().item()
          print(f"  {v.name}: {int(flips.sum())} warm starts decided otherwise (cost ties "
                f"within 1e-5: {tie})", flush=True)
          if not tie:
            raise AssertionError(f"{v.name}: a warm start differs where costs do not tie")
        for i, label in enumerate(("x0", "cost", "grad", "w", "blocks")):
          got, want, want64 = outs[i], plain[i], plain64[i]
          if got is None:
            continue
          if i != 1:
            got, want, want64 = got[~flips], want[~flips], want64[~flips]
          checks.check(v.name, f"warm_start {what} {label}", got.reshape(got.shape[0], -1),
                       want.reshape(want.shape[0], -1), want64.reshape(want64.shape[0], -1))
      del plain, plain64, rows64
      times: dict[str, list[float]] = {}
      for v in turns(with_iter):
        times.setdefault(v.name, []).append(cs.time_ms(calls[v.name], [()], iters=20))
      report(f"warm_start {what}: the solve's start with the list's build (bound "
             f"{bnd[0]:.5f} ms)", times)
      del calls, rows, ws
      gc.collect()
      torch.cuda.empty_cache()

  if "chol" in args.cases:
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
