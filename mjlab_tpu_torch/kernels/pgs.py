"""Projected Gauss-Seidel on the dual of the soft-constraint problem: the
CUDA kernel's wrapper and its plain PyTorch version.

Replaces the JAX package's `pgs_solve` (mjlab_tpu/physics/solver.py:327-362),
MuJoCo's mjSOL_PGS under the pyramidal cone, with its b = J a0 − aref
(:342) and its caller's qfrc_constraint = Jᵀf (:366). Per world it
minimizes 0.5 fᵀ(A + R)f + fᵀb over the boxes [lo, hi], with A = J M⁻¹ Jᵀ
and R = 1/D on the active rows (D > 0), by `iterations` sweeps over the
rows in order from f = 0, and returns f, u = M⁻¹ Jᵀ f (the solver's qacc is
a0 + u) and qfrc = Jᵀ f. An inactive row's box is [0, 0]: its force is
exactly 0 and it takes no part.

Kernel (csrc/pgs.cu): one world per one-warp block. It lists the active
rows, forms w_c = M⁻¹J_cᵀ and b_c one lane per active row, then the dual on
the active rows AR = J_a W_aᵀ + diag(R_a) into a scratch of CAP² per world,
and sweeps keeping the gradient g = AR f + b in the lanes' registers: one
shuffle per row update. A world with more than CAP active rows takes a
u-based sweep inside the same kernel (w_i into a scratch of J's size).
Bound: sequential over a world's active rows; the bytes are J, aref, lo and
hi on the active rows, D, L and a0, and the outputs (chip_smoke.py computes
it from the run's rows).

The plain version forms A and sweeps its rows as the JAX package does,
skipping the rows that are inactive in every world. The wrapper takes it
for a CPU tensor and launches the kernel for a CUDA tensor, with no
fallback between them. Launches are counted in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

MAX_N = 64
CAP = 128  # active rows per world on the kernel's dual path
_EPS = 1e-15

LAUNCHES = {"pgs_solve": 0}


def reset_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def pgs_sweeps_plain(L: torch.Tensor, J: torch.Tensor, D: torch.Tensor, b: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor, iterations: int):
  """(f, u) for L (B, n, n) the lower factor of M, J (B, m, n) and D, b, lo,
  hi (B, m): A = J M⁻¹ Jᵀ, then the row sweeps; a row keeps f = 0 in the
  worlds where it is inactive."""
  Jt = J.transpose(-1, -2)
  MinvJt = torch.linalg.solve_triangular(
    L.transpose(-1, -2), torch.linalg.solve_triangular(L, Jt, upper=False), upper=True)
  A = J @ MinvJt
  active = D > 0
  R = torch.where(active, 1.0 / torch.clamp_min(D, _EPS), torch.zeros_like(D))
  diag = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1) + R, _EPS)
  f = torch.zeros_like(D)
  rows = [(i, A[:, i], R[:, i], b[:, i], diag[:, i], lo[:, i], hi[:, i], active[:, i])
          for i in torch.nonzero(active.any(dim=0)).flatten().tolist()]
  zero = torch.zeros_like(D[:, 0])
  for _ in range(iterations):
    for i, Ai, Ri, bi, di, loi, hii, acti in rows:
      fi = f[:, i]
      g = torch.sum(Ai * f, dim=-1) + Ri * fi + bi
      f[:, i] = torch.where(acti, torch.clamp(fi - g / di, loi, hii), zero)
  return f, (MinvJt @ f[..., None])[..., 0]


def pgs_solve_plain(L: torch.Tensor, J: torch.Tensor, a0: torch.Tensor, aref: torch.Tensor,
                    D: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, iterations: int):
  """(f, u, qfrc) for L (B, n, n), J (B, m, n), a0 (B, n) and aref, D, lo,
  hi (B, m): b = J a0 − aref, the sweeps, and qfrc = Jᵀ f."""
  b = (J @ a0[..., None])[..., 0] - aref
  f, u = pgs_sweeps_plain(L, J, D, b, lo, hi, iterations)
  return f, u, (J.transpose(-1, -2) @ f[..., None])[..., 0]


def instance_n(n: int) -> int:
  """The kernel's compiled width for nv = n: 35 (G1) as it is, else padded
  to 32 or 64."""
  return 35 if n == 35 else (32 if n <= 32 else 64)


def scratch_elems(n: int, m: int) -> tuple[int, int]:
  """Elements per world of the kernel's scratch W (w_c rows of the instance
  width rounded up to 4, or J's size for the u-based branch) and AR (the
  dual on at most CAP active rows)."""
  capr = min(CAP, -(-m // 32) * 32)
  width = -(-instance_n(n) // 4) * 4
  w = max(m * n, capr * width)
  return -(-w // 4) * 4, capr * capr


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_bound: dict[str, ctypes._CFuncPtr] = {}


def _fn(key: str):
  if key not in _bound:
    from mjlab_tpu_torch.kernels import build

    f = getattr(build.library("pgs"), key)
    if key == "pgs_solve_config":
      f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    else:
      f.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    _bound[key] = f
  return _bound[key]


def launch_config(dtype: torch.dtype, n: int) -> dict[str, int]:
  """The launch the kernel makes for this dtype and nv (on the current
  card): resident worlds per SM, SMs, shared bytes per world, registers
  and local (spill) bytes per thread, the compiled width N."""
  out = (ctypes.c_int * 6)()
  rc = _fn("pgs_solve_config")(torch.empty((), dtype=dtype).element_size(), n, out)
  if rc != 0:
    raise RuntimeError(f"pgs_solve_config failed with CUDA error {rc}")
  return dict(zip(("worlds_per_sm", "sms", "shared_bytes", "registers", "spill_bytes", "N"),
                  list(out)))


def _check(t: torch.Tensor, ref: torch.Tensor, shape: tuple, what: str) -> None:
  if t.device != ref.device or t.dtype != ref.dtype:
    raise ValueError(f"pgs_solve: {what} must match L's device and dtype")
  if tuple(t.shape) != shape:
    raise ValueError(f"pgs_solve: {what} has shape {tuple(t.shape)}, expected {shape}")
  if not t.is_contiguous():
    raise ValueError(f"pgs_solve: {what} must be contiguous")


def pgs_solve(L: torch.Tensor, J: torch.Tensor, a0: torch.Tensor, aref: torch.Tensor,
              D: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, iterations: int):
  """(f (B, m), u (B, n), qfrc (B, n)) of `iterations` PGS sweeps from f = 0
  with b = J a0 − aref, for L (B, n, n) the lower Cholesky factor of M,
  J (B, m, n), a0 (B, n) and aref, D, lo, hi (B, m)."""
  if L.device.type == "cpu":
    return pgs_solve_plain(L, J, a0, aref, D, lo, hi, iterations)
  if L.device.type != "cuda":
    raise ValueError(f"pgs_solve: expected a CUDA tensor, got {L.device}")
  if L.dtype not in _SUFFIX:
    raise TypeError(f"pgs_solve: dtype {L.dtype} (float32/float64 only)")
  if L.dim() != 3 or L.shape[1] != L.shape[2] or not 1 <= L.shape[1] <= MAX_N:
    raise ValueError(f"pgs_solve: expected L (B, n, n) with n <= {MAX_N}, got {tuple(L.shape)}")
  if J.dim() != 3 or J.shape[1] < 1:
    raise ValueError(f"pgs_solve: expected J (B, m, n), got {tuple(J.shape)}")
  B, n = L.shape[:2]
  m = J.shape[1]
  _check(L, L, (B, n, n), "L")
  _check(J, L, (B, m, n), "J")
  _check(a0, L, (B, n), "a0")
  for name, x in (("aref", aref), ("D", D), ("lo", lo), ("hi", hi)):
    _check(x, L, (B, m), name)
  f = torch.empty_like(D)
  u = torch.empty((B, n), dtype=L.dtype, device=L.device)
  qfrc = torch.empty_like(u)
  ws, ars = scratch_elems(n, m)
  W = torch.empty((B, ws), dtype=L.dtype, device=L.device)
  AR = torch.empty((B, ars), dtype=L.dtype, device=L.device)
  S = torch.empty((B, 6, m), dtype=L.dtype, device=L.device)
  idx = torch.empty((B, m), dtype=torch.int32, device=L.device)
  stream = torch.cuda.current_stream(L.device).cuda_stream
  with torch.cuda.device(L.device):
    rc = _fn(f"pgs_solve_{_SUFFIX[L.dtype]}")(
      *[t.data_ptr() for t in (L, J, a0, aref, D, lo, hi, f, u, qfrc, W, AR, S, idx)],
      B, n, m, int(iterations), ws, ars, stream)
  if rc != 0:
    raise RuntimeError(f"pgs_solve launch failed with CUDA error {rc}")
  LAUNCHES["pgs_solve"] += 1
  return f, u, qfrc
