"""Projected Gauss-Seidel on the dual of the soft-constraint problem: the
CUDA kernel's wrapper and its plain PyTorch version.

Replaces the JAX package's `pgs_solve` (mjlab_tpu/physics/solver.py:327-362),
MuJoCo's mjSOL_PGS under the pyramidal cone. Per world it minimizes
0.5 fᵀ(A + R)f + fᵀb over the boxes [lo, hi], with A = J M⁻¹ Jᵀ and
R = 1/D on the active rows (D > 0), by `iterations` sweeps over the rows in
order from f = 0, and returns f and u = M⁻¹ Jᵀ f (the solver's qacc is
qacc_smooth + u).

Kernel (csrc/pgs.cu): one world per one-warp block; it never forms A (A_i f
= J_i u, and a row's change d adds d·M⁻¹J_iᵀ to u), compacts the active rows
once, solves each one's w_i = M⁻¹J_iᵀ against the factor L in shared memory
into a scratch of J's size, and keeps u in registers through the sweeps.
Bound: sequential over a world's active rows; the bytes are J's active rows
once, L, the row vectors and the outputs (chip_smoke.py computes it from
the run's rows).

The plain version forms A and sweeps its rows as the JAX package does,
skipping the rows that are inactive in every world (their force stays 0).
The wrapper takes it for a CPU tensor and launches the kernel for a CUDA
tensor, with no fallback between them. Launches are counted in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

MAX_N = 64
_EPS = 1e-15

LAUNCHES = {"pgs_solve": 0}


def reset_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def pgs_solve_plain(L: torch.Tensor, J: torch.Tensor, D: torch.Tensor, b: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor, iterations: int):
  """(f, u) for L (B, n, n) the lower factor of M, J (B, m, n) and D, b, lo,
  hi (B, m): A = J M⁻¹ Jᵀ, then the row sweeps."""
  Jt = J.transpose(-1, -2)
  MinvJt = torch.linalg.solve_triangular(
    L.transpose(-1, -2), torch.linalg.solve_triangular(L, Jt, upper=False), upper=True)
  A = J @ MinvJt
  active = D > 0
  R = torch.where(active, 1.0 / torch.clamp_min(D, _EPS), torch.zeros_like(D))
  diag = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1) + R, _EPS)
  f = torch.zeros_like(D)
  rows = [(i, A[:, i], R[:, i], b[:, i], diag[:, i], lo[:, i], hi[:, i])
          for i in torch.nonzero(active.any(dim=0)).flatten().tolist()]
  for _ in range(iterations):
    for i, Ai, Ri, bi, di, loi, hii in rows:
      fi = f[:, i]
      g = torch.sum(Ai * f, dim=-1) + Ri * fi + bi
      f[:, i] = torch.clamp(fi - g / di, loi, hii)
  return f, (MinvJt @ f[..., None])[..., 0]


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_bound: dict[str, ctypes._CFuncPtr] = {}


def _fn(dtype: torch.dtype):
  key = f"pgs_solve_{_SUFFIX[dtype]}"
  if key not in _bound:
    from mjlab_tpu_torch.kernels import build

    f = getattr(build.library("pgs"), key)
    f.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    _bound[key] = f
  return _bound[key]


def _check(t: torch.Tensor, ref: torch.Tensor, shape: tuple, what: str) -> None:
  if t.device != ref.device or t.dtype != ref.dtype:
    raise ValueError(f"pgs_solve: {what} must match L's device and dtype")
  if tuple(t.shape) != shape:
    raise ValueError(f"pgs_solve: {what} has shape {tuple(t.shape)}, expected {shape}")
  if not t.is_contiguous():
    raise ValueError(f"pgs_solve: {what} must be contiguous")


def pgs_solve(L: torch.Tensor, J: torch.Tensor, D: torch.Tensor, b: torch.Tensor,
              lo: torch.Tensor, hi: torch.Tensor, iterations: int):
  """(f (B, m), u (B, n)) of `iterations` PGS sweeps from f = 0, for L
  (B, n, n) the lower Cholesky factor of M, J (B, m, n), and D, b, lo, hi
  (B, m); A is never formed in device memory."""
  if L.device.type == "cpu":
    return pgs_solve_plain(L, J, D, b, lo, hi, iterations)
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
  for name, x in (("D", D), ("b", b), ("lo", lo), ("hi", hi)):
    _check(x, L, (B, m), name)
  f = torch.empty_like(D)
  u = torch.empty((B, n), dtype=L.dtype, device=L.device)
  W = torch.empty_like(J)  # w_i = M⁻¹J_iᵀ of the active rows, compacted
  S = torch.empty((B, 6, m), dtype=L.dtype, device=L.device)
  idx = torch.empty((B, m), dtype=torch.int32, device=L.device)
  stream = torch.cuda.current_stream(L.device).cuda_stream
  with torch.cuda.device(L.device):
    rc = _fn(L.dtype)(*[t.data_ptr() for t in (L, J, D, b, lo, hi, f, u, W, S, idx)],
                      B, n, m, int(iterations), stream)
  if rc != 0:
    raise RuntimeError(f"pgs_solve launch failed with CUDA error {rc}")
  LAUNCHES["pgs_solve"] += 1
  return f, u
