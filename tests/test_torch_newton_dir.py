"""The Newton step's fused direction (kernels/chol.py `newton_direction`):
its plain version against the JAX package's formula, and its wrapper.

JAX's Newton step (mjlab_tpu/physics/solver.py:222, 227-229) builds
H = qM + (J.T * w) @ J, factors H + 1e-10·I and solves twice. The plain
version must match that to 1e-10 relative in float64 at G1's nv = 35 with a
small row count; rows whose weight is 0 must change nothing, bitwise; a
non-positive pivot must give a NaN direction. On a CPU tensor the wrapper
takes the plain path and counts no launch. The `gpu` cases hold the kernel
against the plain version on the card (float64 within 1e-10 relative;
float32 within max(1e-5 × scale, 4 × the plain float32 version's own error
against float64)), for dense, sparse and all-zero weights and row counts
that leave each world's J unaligned.

The elliptic entry `newton_direction_cone` adds Σ_s J_sᵀ B_s J_s over cone
slots of dim 3, 4 and 6 (JAX's einsum at solver.py:223-225): its plain
version must match the JAX formula at 1e-10 relative in float64 with blocks
of all three zones (0, diagonal, dense), slots whose block is 0 must change
nothing, bitwise; on the card the kernel is held to the plain version as
above, also with every row and every slot inactive, and with every slot
active. The kernel runs one world per one-warp block, the whole batch in
one grid: the card tests also cover a grid of more blocks than the card
holds at once, with an odd tail, active rows at the edges of the kernel's
16-byte scan loads and 32-row tiles, more slots than fit one tile, and the
bitwise property for the cone's all-zero blocks. On the card:
  python -m pytest --noconftest -m gpu tests/test_torch_newton_dir.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import chol

NV = 35  # G1


def _problem(seed, batch, n, m, pattern):
  rng = np.random.default_rng(seed)
  X = rng.normal(size=(batch, n, n))
  qM = X @ np.swapaxes(X, -1, -2) / n + 0.1 * np.eye(n)
  J = rng.normal(size=(batch, m, n))
  w = rng.uniform(0.5, 2.0, size=(batch, m))
  if pattern == "sparse":
    w = np.where(rng.uniform(size=(batch, m)) < 0.2, w, 0.0)
  elif pattern == "zero":
    w = np.zeros((batch, m))
  grad = rng.normal(size=(batch, n))
  return qM, J, w, grad


def _cone_problem(seed, batch, n, m_reg, dims, pattern="zones"):
  """Regular rows, then one slot per entry of `dims` (cd consecutive rows
  each, grouped by dim as the solver lays them out), with packed blocks:
  `zones` cycles the top (0), bottom (diagonal) and middle (dense PSD)
  zones' shapes over the slots; `active` cycles the bottom and middle ones
  (no block is 0); `zero` leaves every block 0."""
  qM, J, w, grad = _problem(seed, batch, n, m_reg + sum(dims), "sparse")
  rng = np.random.default_rng(seed + 100)
  w[:, m_reg:] = 0.0
  table, blocks, row, off = [], [], m_reg, 0
  for s, cd in enumerate(dims):
    table.append((row, cd, off))
    X = rng.normal(size=(batch, cd, cd))
    dense = X @ np.swapaxes(X, -1, -2) + 0.1 * np.eye(cd)
    diag = np.eye(cd) * rng.uniform(0.5, 2.0, size=(batch, 1, cd))
    zone = {"zones": (s + np.arange(batch)) % 3, "active": 1 + (s + np.arange(batch)) % 2,
            "zero": np.zeros(batch, int)}[pattern]
    b = np.where((zone == 1)[:, None, None], diag, np.where((zone == 2)[:, None, None], dense, 0.0))
    blocks.append(b.reshape(batch, cd * cd))
    row, off = row + cd, off + cd * cd
  groups, start = [], 0
  for i in range(1, len(dims) + 1):
    if i == len(dims) or dims[i] != dims[start]:
      groups.append((dims[start], start, i - start))
      start = i
  Bc = np.concatenate(blocks, axis=1) if blocks else np.zeros((batch, 0))
  return (qM, J, w, grad, Bc), (np.asarray(table, dtype=np.int32).reshape(-1, 3),
                               tuple(groups), off)


def _layout(host, device="cpu"):
  table, groups, nb = host
  return chol.ConeLayout(torch.as_tensor(table, device=device), groups, nb)


def _jax_cone_direction(qM, J, w, grad, Bc, host):
  import jax
  import jax.numpy as jnp
  from jax.scipy.linalg import solve_triangular

  table = host[0]

  def one(qM, J, w, g, Bc):
    H = qM + (J.T * w[None, :]) @ J
    for adr, cd, off in table:
      Js = J[adr : adr + cd]
      H = H + Js.T @ Bc[off : off + cd * cd].reshape(cd, cd) @ Js
    L = jnp.linalg.cholesky(H + 1e-10 * jnp.eye(qM.shape[0], dtype=qM.dtype))
    y = solve_triangular(L, g, lower=True)
    return solve_triangular(L.T, y, lower=False)

  return np.asarray(jax.vmap(one)(qM, J, w, grad, Bc))


def _jax_direction(qM, J, w, grad):
  import jax
  import jax.numpy as jnp
  from jax.scipy.linalg import solve_triangular

  def one(qM, J, w, g):
    H = qM + (J.T * w[None, :]) @ J
    L = jnp.linalg.cholesky(H + 1e-10 * jnp.eye(qM.shape[0], dtype=qM.dtype))
    y = solve_triangular(L, g, lower=True)
    return solve_triangular(L.T, y, lower=False)

  return np.asarray(jax.vmap(one)(qM, J, w, grad))


def _rel(a, b):
  return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


def _torch(*arrays, dtype=torch.float64, device="cpu"):
  return [torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
          for a in arrays]


@pytest.mark.parametrize("pattern", ["dense", "sparse", "zero"])
def test_plain_matches_jax(pattern):
  qM, J, w, grad = _problem(0, 8, NV, 64, pattern)
  x_ref = _jax_direction(qM, J, w, grad)
  x = chol.newton_direction_plain(*_torch(qM, J, w, grad)).numpy()
  assert _rel(x, x_ref) < 1e-10


def test_zero_weight_rows_change_nothing():
  qM, J, w, grad = _problem(1, 4, NV, 64, "dense")
  w[:, 5:45] = 0.0  # the same rows in every world, so they can be removed
  J[:, 5:45] *= 1e3  # large, to show they are not added in
  keep = np.r_[0:5, 45:64]
  full = chol.newton_direction_plain(*_torch(qM, J, w, grad))
  cut = chol.newton_direction_plain(*_torch(qM, J[:, keep], w[:, keep], grad))
  assert torch.equal(full, cut)


def test_nonpositive_pivot_gives_nan_direction():
  qM, J, w, grad = _problem(2, 3, NV, 64, "sparse")
  qM[1] = -np.eye(NV)  # negative definite: the first pivot fails
  w[1] = 0.0
  x_ref = _jax_direction(qM, J, w, grad)
  x = chol.newton_direction_plain(*_torch(qM, J, w, grad)).numpy()
  assert np.array_equal(np.isnan(x), np.isnan(x_ref))
  assert np.isnan(x[1]).all() and np.isfinite(x[[0, 2]]).all()


def test_cpu_wrapper_takes_plain_path_and_counts_nothing():
  args = _torch(*_problem(3, 3, 7, 11, "sparse"))
  chol.reset_counts()
  assert torch.equal(chol.newton_direction(*args), chol.newton_direction_plain(*args))
  assert all(v == 0 for v in chol.LAUNCHES.values())
  assert chol.factorizations() == 0


CONE_DIMS = {"3": [3] * 6, "3,4,6": [3, 3, 4, 4, 6, 6, 6], "6": [6] * 3}


@pytest.mark.parametrize("dims", sorted(CONE_DIMS))
def test_cone_plain_matches_jax(dims):
  arrays, host = _cone_problem(6, 9, NV, 40, CONE_DIMS[dims])
  x_ref = _jax_cone_direction(*arrays, host)
  x = chol.newton_direction_cone_plain(*_torch(*arrays), _layout(host)).numpy()
  assert _rel(x, x_ref) < 1e-10


def test_cone_zero_blocks_change_nothing():
  """A slot in the top zone (B = 0) adds nothing: the direction equals the
  one without the slot, bitwise, as for a row of weight 0."""
  (qM, J, w, grad, Bc), host = _cone_problem(7, 6, NV, 30, [3, 3, 3])
  Bc[:, 9:18] = 0.0  # the middle slot
  keep_rows = np.r_[0:33, 36:39]
  table = np.asarray([(30, 3, 0), (33, 3, 9)], dtype=np.int32)
  cut_host = (table, ((3, 0, 2),), 18)
  full = chol.newton_direction_cone_plain(*_torch(qM, J, w, grad, Bc), _layout(host))
  cut = chol.newton_direction_cone_plain(
    *_torch(qM, J[:, keep_rows], w[:, keep_rows], grad, np.c_[Bc[:, :9], Bc[:, 18:]]),
    _layout(cut_host))
  assert torch.equal(full, cut)


def test_cone_cpu_wrapper_takes_plain_path_and_counts_nothing():
  arrays, host = _cone_problem(8, 3, 9, 5, [3, 4])
  args = _torch(*arrays)
  chol.reset_counts()
  assert torch.equal(chol.newton_direction_cone(*args, _layout(host)),
                     chol.newton_direction_cone_plain(*args, _layout(host)))
  assert chol.factorizations() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n, m, dims", [(35, 200, "3"), (35, 29, "3,4,6"), (20, 33, "6"),
                                        (50, 9, "3,4,6"), (7, 0, "3"), (27, 24, "3"),
                                        (2, 1, "3")])
@pytest.mark.parametrize("pattern", ["zones", "active", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cone_kernel_matches_plain_on_card(n, m, dims, pattern, dtype):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  arrays, host = _cone_problem(9, 37, n, m, CONE_DIMS[dims], pattern)
  if pattern == "zero":
    arrays[2][:] = 0.0  # and every regular row inactive
  layout = _layout(host, "cuda")
  args = _torch(*arrays, dtype=dtype, device="cuda")
  chol.reset_counts()
  x = chol.newton_direction_cone(*args, layout)
  torch.cuda.synchronize()
  assert chol.LAUNCHES["newton_direction_cone"] == 1
  x64 = chol.newton_direction_cone_plain(*_torch(*arrays, device="cuda"), layout)
  err = (x.double() - x64).abs().max().item()
  scale = max(1.0, x64.abs().max().item())
  if dtype == torch.float64:
    assert err <= 1e-10 * scale
  else:
    ref_err = (chol.newton_direction_cone_plain(*args, layout).double() - x64).abs().max().item()
    assert err <= max(1e-5 * scale, 4 * ref_err)


@pytest.mark.gpu
@pytest.mark.parametrize("n, m", [(35, 1699), (35, 67), (20, 33), (50, 129), (7, 0),
                                  (27, 141), (2, 1)])
@pytest.mark.parametrize("pattern", ["dense", "sparse", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(n, m, pattern, dtype):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  problem = _problem(4, 37, n, m, pattern)
  args = _torch(*problem, dtype=dtype, device="cuda")
  chol.reset_counts()
  x = chol.newton_direction(*args)
  torch.cuda.synchronize()
  assert chol.LAUNCHES["newton_direction"] == 1
  x64 = chol.newton_direction_plain(*_torch(*problem, device="cuda"))
  err = (x.double() - x64).abs().max().item()
  scale = max(1.0, x64.abs().max().item())
  if dtype == torch.float64:
    assert err <= 1e-10 * scale
  else:
    ref_err = (chol.newton_direction_plain(*args).double() - x64).abs().max().item()
    assert err <= max(1e-5 * scale, 4 * ref_err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_zero_weight_rows_and_bad_pivot_on_card(dtype):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  qM, J, w, grad = _problem(5, 9, NV, 129, "dense")
  w[:, 3:100] = 0.0
  keep = np.r_[0:3, 100:129]
  full = chol.newton_direction(*_torch(qM, J, w, grad, dtype=dtype, device="cuda"))
  cut = chol.newton_direction(
    *_torch(qM, J[:, keep], w[:, keep], grad, dtype=dtype, device="cuda")
  )
  assert torch.equal(full, cut)
  qM[4] = -np.eye(NV)
  w[4] = 0.0
  x = chol.newton_direction(*_torch(qM, J, w, grad, dtype=dtype, device="cuda"))
  assert torch.isnan(x[4]).all()
  assert torch.isfinite(x[:4]).all() and torch.isfinite(x[5:]).all()


def _assert_card_close(x, x64, x32_plain, dtype):
  """The card's rule: float64 within 1e-10 relative; float32 within
  max(1e-5 × scale, 4 × the plain float32 version's own error), with
  the same NaN pattern."""
  assert torch.equal(torch.isnan(x), torch.isnan(x64))
  ok = ~torch.isnan(x64)
  err = (x.double() - x64)[ok].abs().max().item()
  scale = max(1.0, x64[ok].abs().max().item())
  if dtype == torch.float64:
    assert err <= 1e-10 * scale
  else:
    ref_err = (x32_plain.double() - x64)[ok].abs().max().item()
    assert err <= max(1e-5 * scale, 4 * ref_err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_batch_past_one_wave_on_card(dtype):
  """4096 + 37 worlds at G1's shapes with sparse weights: one one-warp
  block per world, so a grid of more blocks than the card holds at once
  (16 per SM in f32, 8 in f64), with an odd tail of 37, and rows of w past
  one scan batch (1699 rows; 1024 per batch in f32, 512 in f64)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  gen = torch.Generator(device="cuda").manual_seed(11)
  B, m = 4096 + 37, 1699
  X = torch.randn(B, NV, NV, generator=gen, device="cuda", dtype=torch.float64)
  qM = X @ X.mT / NV + 0.1 * torch.eye(NV, device="cuda", dtype=torch.float64)
  J = torch.randn(B, m, NV, generator=gen, device="cuda", dtype=torch.float64)
  w = torch.rand(B, m, generator=gen, device="cuda", dtype=torch.float64) + 0.5
  w = torch.where(torch.rand(B, m, generator=gen, device="cuda") < 0.03, w, 0.0)
  grad = torch.randn(B, NV, generator=gen, device="cuda", dtype=torch.float64)
  args = [a.to(dtype) for a in (qM, J, w, grad)]
  chol.reset_counts()
  x = chol.newton_direction(*args)
  torch.cuda.synchronize()
  assert chol.LAUNCHES["newton_direction"] == 1
  x64 = chol.newton_direction_plain(*[a.double() for a in args])
  _assert_card_close(x, x64, chol.newton_direction_plain(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_active_rows_at_scan_and_tile_edges_on_card(dtype):
  """World b has exactly COUNTS[b] active rows of 600, so that they end at
  and straddle the kernel's 32-row tiles and its 16-byte scan loads of w
  (4 rows in f32, 2 in f64)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  counts = [0, 1, 31, 32, 33, 63, 64, 65, 255, 256, 257, 600]
  qM, J, w, grad = _problem(12, len(counts), NV, 600, "dense")
  rng = np.random.default_rng(12)
  for b, k in enumerate(counts):
    keep = np.zeros(600, bool)
    keep[rng.choice(600, k, replace=False)] = True
    w[b] = np.where(keep, w[b], 0.0)
  args = _torch(qM, J, w, grad, dtype=dtype, device="cuda")
  x = chol.newton_direction(*args)
  x64 = chol.newton_direction_plain(*_torch(qM, J, w, grad, device="cuda"))
  _assert_card_close(x, x64, chol.newton_direction_plain(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["zones", "active"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cone_kernel_many_slots_on_card(pattern, dtype):
  """G1 elliptic's count of dim-3 slots (379, more than one tile holds)
  behind 183 regular rows, at 300 worlds, the last slot on the last row."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  arrays, host = _cone_problem(13, 300, NV, 183, [3] * 379, pattern)
  layout = _layout(host, "cuda")
  args = _torch(*arrays, dtype=dtype, device="cuda")
  x = chol.newton_direction_cone(*args, layout)
  x64 = chol.newton_direction_cone_plain(*_torch(*arrays, device="cuda"), layout)
  _assert_card_close(x, x64, chol.newton_direction_cone_plain(*args, layout), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cone_kernel_zero_blocks_change_nothing_on_card(dtype):
  """A slot whose block is all 0 changes x not at all, bitwise: the
  direction equals the one with the slot (and its rows) removed."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  (qM, J, w, grad, Bc), host = _cone_problem(14, 9, NV, 30, [3, 3, 3, 4, 6], "active")
  Bc[:, 9:18] = 0.0  # the second slot
  keep_rows = np.r_[0:33, 36:49]
  cut_host = (np.asarray([(30, 3, 0), (33, 3, 9), (36, 4, 18), (40, 6, 34)], dtype=np.int32),
              ((3, 0, 2), (4, 2, 1), (6, 3, 1)), 70)
  full = chol.newton_direction_cone(*_torch(qM, J, w, grad, Bc, dtype=dtype, device="cuda"),
                                    _layout(host, "cuda"))
  cut = chol.newton_direction_cone(
    *_torch(qM, J[:, keep_rows], w[:, keep_rows], grad, np.c_[Bc[:, :9], Bc[:, 18:]],
            dtype=dtype, device="cuda"),
    _layout(cut_host, "cuda"))
  assert torch.equal(full, cut)
