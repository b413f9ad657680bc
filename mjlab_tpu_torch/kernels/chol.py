"""Batched dense Cholesky factor and solves, and the Newton step's fused
direction: the CUDA kernels' wrappers and their plain PyTorch versions.

Replaces the XLA-fused `jnp.linalg.cholesky` + `jax.scipy.linalg.
solve_triangular` pairs of the JAX package at mjlab_tpu/physics/smooth.py:233
(factor_m), :238-239 (solve_m) and forward.py:116-118 (implicit integrator),
and the Newton step's H = qM + Jᵀ diag(w) J with its factor and solves at
solver.py:222, 227-229. One physics substep runs 12 factorizations:
factor_m, 10 Newton directions, integrate.

Kernels (csrc/):
- chol.cu: one warp per matrix, several matrices per block, rows in
  registers, one shuffle and one __syncwarp per column. Bound on the H100
  at B=4096, n=35, f32: the factor needs A's lower triangle (10.3 MB) and
  writes L (20.1 MB), ~9.1 µs at 3.35 TB/s; a solve needs L's lower
  triangle and b and writes x (11.5 MB), ~3.4 µs.
- newton_dir.cu: one world per one-warp block, the whole batch launched
  at once (16 resident per SM at G1's shapes in f32); qM is copied into
  shared memory while w is scanned with 16-byte loads, the rows of J whose
  weight is not 0 stream through a double-buffered pair of tiles, H is
  built in registers and shared memory and factored and solved with
  chol.cu's warp code; H never reaches device memory. Bound at G1's
  shapes: reading the dense J (0.97 GB) once, 0.29 ms, or only its active
  rows. Its elliptic entry, `newton_direction_cone`, also adds each cone
  slot's J_sᵀ B_s J_s (solver.py:223-225) for the slots whose block is not
  0, their rows through the same tiles; bound at G1 elliptic (4096 × 1320
  × 35, f32): 0.76 GB of J, 0.23 ms, or its active rows.

Semantics (JAX's): a non-positive pivot gives NaN in the whole lower
triangle of L, and NaN in the solution, instead of raising.

Each wrapper takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, with no fallback between them. Launches are counted in
`LAUNCHES` (a fused call counts once); `factorizations()` sums the
factorizing entry points.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

MAX_N = 64

LAUNCHES = {
  "chol_factor": 0, "chol_solve": 0, "chol_factor_solve": 0, "newton_direction": 0,
  "newton_direction_cone": 0,
}


def reset_counts() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def factorizations() -> int:
  return (LAUNCHES["chol_factor"] + LAUNCHES["chol_factor_solve"]
          + LAUNCHES["newton_direction"] + LAUNCHES["newton_direction_cone"])


# ---------------------------------------------------------------------------
# Plain versions (CPU path and the kernels' check).
# ---------------------------------------------------------------------------


def chol_factor_plain(A: torch.Tensor) -> torch.Tensor:
  """Column-by-column batched Cholesky, NaN on a non-positive pivot."""
  n = A.shape[-1]
  L = torch.zeros_like(A)
  ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
  for j in range(n):
    s = A[..., j:, j] - (L[..., j:, :j] @ L[..., j, :j, None])[..., 0]
    ok = ok & (s[..., 0] > 0)
    djj = torch.sqrt(s[..., 0])
    L[..., j, j] = djj
    L[..., j + 1 :, j] = s[..., 1:] / djj[..., None]
  lower = torch.ones(n, n, dtype=torch.bool, device=A.device).tril()
  bad = ~ok[..., None, None] & lower
  return torch.where(bad, torch.full_like(L, float("nan")), L)


def chol_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L Lᵀ x = b by forward then back substitution."""
  n = L.shape[-1]
  y = torch.zeros_like(b)
  for i in range(n):
    y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) / L[..., i, i]
  x = torch.zeros_like(b)
  for i in range(n - 1, -1, -1):
    acc = (L[..., i + 1 :, i] * x[..., i + 1 :]).sum(-1)
    x[..., i] = (y[..., i] - acc) / L[..., i, i]
  return x


def chol_factor_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return chol_solve_plain(chol_factor_plain(A), b)


def newton_matrix(qM: torch.Tensor, J: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """The Newton step's H = qM + Jᵀ diag(w) J + 1e-10·I, for qM (B, n, n),
  J (B, m, n), w (B, m). The regularization guards rank-deficient active
  sets in f32."""
  H = qM + (J.mT * w[:, None, :]) @ J
  return H + 1e-10 * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)


def newton_direction_plain(qM, J, w, grad) -> torch.Tensor:
  return chol_factor_solve_plain(newton_matrix(qM, J, w), grad)


@dataclasses.dataclass(frozen=True, eq=False)
class ConeLayout:
  """Where the elliptic cone slots' rows and Hessian blocks lie: per slot
  (S, 3) int32 [first efc row, dim cd, offset of its cd × cd block in the
  packed blocks (B, nb), row-major], slots grouped by dim; `groups` holds
  (dim, first slot, slot count) of each group."""

  table: torch.Tensor
  groups: tuple[tuple[int, int, int], ...]
  nb: int


def cone_matrix(qM, J, w, Bc, layout: ConeLayout) -> torch.Tensor:
  """The elliptic Newton step's H = qM + Jᵀ diag(w) J + Σ_s J_sᵀ B_s J_s +
  1e-10·I (the JAX package's order: solver.py:222-227), for the packed cone
  blocks Bc (B, nb)."""
  H = qM + (J.mT * w[:, None, :]) @ J
  for cd, s0, n in layout.groups:
    rows = layout.table[s0 : s0 + n, 0].long()[:, None] + torch.arange(cd, device=J.device)
    Js = J[:, rows]  # (B, n, cd, nv)
    Bg = _group_blocks(Bc, layout, s0, n, cd)
    H = H + torch.einsum("bsiv,bsij,bsjw->bvw", Js, Bg, Js)
  return H + 1e-10 * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)


def _group_blocks(Bc, layout: ConeLayout, s0: int, n: int, cd: int):
  """A group's (B, n, cd, cd) blocks of the packed cone Hessians: groups lie
  in slot order, so the group's offset is the sum of the earlier ones'."""
  start = sum(c * c * k for c, first, k in layout.groups if first < s0)
  return Bc[:, start : start + n * cd * cd].reshape(Bc.shape[0], n, cd, cd)


def newton_direction_cone_plain(qM, J, w, grad, Bc, layout: ConeLayout) -> torch.Tensor:
  return chol_factor_solve_plain(cone_matrix(qM, J, w, Bc, layout), grad)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_LIBRARY = {"newton_direction": "newton_dir",
            "newton_direction_cone": "newton_dir"}  # else csrc/chol.cu
_bound: dict[str, ctypes._CFuncPtr] = {}


def _fn(name: str, dtype: torch.dtype, nptr: int, nint: int):
  key = f"{name}_{_SUFFIX[dtype]}"
  if key not in _bound:
    from mjlab_tpu_torch.kernels import build

    f = getattr(build.library(_LIBRARY.get(name, "chol")), key)
    f.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    _bound[key] = f
  return _bound[key]


def _check(t: torch.Tensor, ref: torch.Tensor, shape: tuple, what: str) -> None:
  if t.device != ref.device or t.dtype != ref.dtype:
    raise ValueError(f"{what}: every tensor must match the matrix's device and dtype")
  if tuple(t.shape) != shape:
    raise ValueError(f"{what}: shape {tuple(t.shape)} != {shape}")
  if not t.is_contiguous():
    raise ValueError(f"{what}: tensors must be contiguous")


def _check_matrix(A: torch.Tensor, what: str) -> None:
  if A.device.type != "cuda":
    raise ValueError(f"{what}: expected a CUDA tensor, got {A.device}")
  if A.dtype not in _SUFFIX:
    raise TypeError(f"{what}: dtype {A.dtype} (float32/float64 only)")
  if A.dim() != 3 or A.shape[1] != A.shape[2]:
    raise ValueError(f"{what}: expected (B, n, n), got {tuple(A.shape)}")
  if A.shape[1] > MAX_N:
    raise ValueError(f"{what}: n={A.shape[1]} exceeds the kernel's {MAX_N}")
  if not A.is_contiguous():
    raise ValueError(f"{what}: tensor must be contiguous")


def _launch(name: str, tensors: tuple, ints: tuple) -> None:
  ref = tensors[0]
  f = _fn(name, ref.dtype, len(tensors), len(ints))
  stream = torch.cuda.current_stream(ref.device).cuda_stream
  with torch.cuda.device(ref.device):
    rc = f(*[t.data_ptr() for t in tensors], *ints, stream)
  if rc != 0:
    raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
  LAUNCHES[name] += 1


def chol_factor(A: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of a batch (B, n, n) of SPD matrices."""
  if A.device.type == "cpu":
    return chol_factor_plain(A)
  _check_matrix(A, "chol_factor")
  L = torch.empty_like(A)
  _launch("chol_factor", (A, L), A.shape[:2])
  return L


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x with L Lᵀ x = b, for L (B, n, n) lower and b (B, n)."""
  if L.device.type == "cpu":
    return chol_solve_plain(L, b)
  _check_matrix(L, "chol_solve")
  _check(b, L, L.shape[:2], "chol_solve")
  x = torch.empty_like(b)
  _launch("chol_solve", (L, b, x), L.shape[:2])
  return x


def chol_factor_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x with A x = b through A's Cholesky factor, which is not kept."""
  if A.device.type == "cpu":
    return chol_factor_solve_plain(A, b)
  _check_matrix(A, "chol_factor_solve")
  _check(b, A, A.shape[:2], "chol_factor_solve")
  x = torch.empty_like(b)
  _launch("chol_factor_solve", (A, b, x), A.shape[:2])
  return x


def newton_direction(qM: torch.Tensor, J: torch.Tensor, w: torch.Tensor,
                     grad: torch.Tensor) -> torch.Tensor:
  """x with (qM + Jᵀ diag(w) J + 1e-10·I) x = grad, for qM (B, n, n),
  J (B, m, n), w (B, m) and grad (B, n); H is neither kept nor formed in
  device memory."""
  if qM.device.type == "cpu":
    return newton_direction_plain(qM, J, w, grad)
  _check_matrix(qM, "newton_direction")
  B, n = qM.shape[:2]
  if J.dim() != 3:
    raise ValueError(f"newton_direction: expected J (B, m, n), got {tuple(J.shape)}")
  m = J.shape[1]
  _check(J, qM, (B, m, n), "newton_direction")
  _check(w, qM, (B, m), "newton_direction")
  _check(grad, qM, (B, n), "newton_direction")
  x = torch.empty_like(grad)
  _launch("newton_direction", (qM, J, w, grad, x), (B, n, m))
  return x


def newton_direction_cone(qM: torch.Tensor, J: torch.Tensor, w: torch.Tensor,
                          grad: torch.Tensor, Bc: torch.Tensor,
                          layout: ConeLayout) -> torch.Tensor:
  """x with (qM + Jᵀ diag(w) J + Σ_s J_sᵀ B_s J_s + 1e-10·I) x = grad: the
  elliptic Newton step, for the packed cone blocks Bc (B, nb) that `layout`
  places (a slot's block is all 0 in the cone's top zone, and skipped); H
  is neither kept nor formed in device memory."""
  if qM.device.type == "cpu":
    return newton_direction_cone_plain(qM, J, w, grad, Bc, layout)
  _check_matrix(qM, "newton_direction_cone")
  B, n = qM.shape[:2]
  if J.dim() != 3:
    raise ValueError(f"newton_direction_cone: expected J (B, m, n), got {tuple(J.shape)}")
  m = J.shape[1]
  S = layout.table.shape[0]
  _check(J, qM, (B, m, n), "newton_direction_cone")
  _check(w, qM, (B, m), "newton_direction_cone")
  _check(grad, qM, (B, n), "newton_direction_cone")
  _check(Bc, qM, (B, layout.nb), "newton_direction_cone")
  tab = layout.table
  if tab.device != qM.device or tab.dtype != torch.int32 or not tab.is_contiguous():
    raise ValueError("newton_direction_cone: the layout must be contiguous int32 on the card")
  x = torch.empty_like(grad)
  _launch("newton_direction_cone", (qM, J, w, grad, Bc, tab, x), (B, n, m, S, layout.nb))
  return x
