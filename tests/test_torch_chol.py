"""The Cholesky kernel's plain version against JAX, and its wrapper's routing.

The plain version (kernels/chol.py) must match `jnp.linalg.cholesky` and
`jax.scipy.linalg.solve_triangular` in float64 to 1e-12 relative on SPD
batches, and reproduce JAX's NaN semantics on non-positive-definite input.
On a CPU tensor the wrappers take the plain path and count no launch. The
`gpu` cases compare kernel and plain version where a card exists (float32
within 1e-4 of the plain version's scale; float64 within 1e-12), for every
instance of the kernel (n = 35 unrolled, n <= 32 and n <= 64 padded) and for
batches that do not fill the last block.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import chol


def _spd(rng, batch, n, cond=1e3):
  q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
  eig = np.exp(rng.uniform(0.0, np.log(cond), size=(batch, n)))
  return (q * eig[:, None, :]) @ np.swapaxes(q, -1, -2)


def _jax_factor_solve(A, b):
  # JAX is imported here so that the `gpu` case runs where JAX is absent:
  #   python -m pytest --noconftest -m gpu tests/test_torch_chol.py
  import jax
  import jax.numpy as jnp

  L = jnp.linalg.cholesky(A)
  y = jax.vmap(lambda L_, b_: jax.scipy.linalg.solve_triangular(L_, b_, lower=True))(L, b)
  x = jax.vmap(
    lambda L_, y_: jax.scipy.linalg.solve_triangular(L_.T, y_, lower=False)
  )(L, y)
  return np.asarray(L), np.asarray(x)


def _rel(a, b):
  return np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("n", [1, 6, 35, 64])
def test_plain_matches_jax(n):
  rng = np.random.default_rng(n)
  A = _spd(rng, 16, n)
  b = rng.normal(size=(16, n))
  L_ref, x_ref = _jax_factor_solve(A, b)
  At, bt = torch.tensor(A), torch.tensor(b)
  L = chol.chol_factor_plain(At).numpy()
  assert _rel(L, L_ref) < 1e-12
  assert np.all(np.triu(L, 1) == 0.0)
  assert _rel(chol.chol_solve_plain(torch.tensor(L), bt).numpy(), x_ref) < 1e-10
  assert _rel(chol.chol_factor_solve_plain(At, bt).numpy(), x_ref) < 1e-10


def test_plain_nan_semantics_match_jax():
  rng = np.random.default_rng(0)
  A = _spd(rng, 4, 5)
  A[1, 3, 3] = -1.0  # indefinite: a non-positive pivot at column 3
  A[2] = -A[2]  # negative definite: fails at column 0
  b = rng.normal(size=(4, 5))
  L_ref, x_ref = _jax_factor_solve(A, b)
  L = chol.chol_factor_plain(torch.tensor(A)).numpy()
  assert np.array_equal(np.isnan(L), np.isnan(L_ref))
  assert np.isnan(L[1]).sum() == 15 and np.isnan(L[2]).sum() == 15
  assert np.all(L[1][np.triu_indices(5, 1)] == 0.0)
  ok = ~np.isnan(L_ref)
  assert np.max(np.abs(L[ok] - L_ref[ok])) < 1e-12
  x = chol.chol_factor_solve_plain(torch.tensor(A), torch.tensor(b)).numpy()
  assert np.array_equal(np.isnan(x), np.isnan(x_ref))
  assert np.isnan(x[1]).all() and np.isfinite(x[0]).all()


def test_cpu_wrappers_take_plain_path_and_count_nothing():
  rng = np.random.default_rng(1)
  A = torch.tensor(_spd(rng, 3, 7))
  b = torch.tensor(rng.normal(size=(3, 7)))
  chol.reset_counts()
  L = chol.chol_factor(A)
  assert torch.equal(L, chol.chol_factor_plain(A))
  assert torch.equal(chol.chol_solve(L, b), chol.chol_solve_plain(L, b))
  assert torch.equal(chol.chol_factor_solve(A, b), chol.chol_factor_solve_plain(A, b))
  assert chol.LAUNCHES == {
    "chol_factor": 0, "chol_solve": 0, "chol_factor_solve": 0, "newton_direction": 0,
    "newton_direction_cone": 0,
  }
  assert chol.factorizations() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card(dtype, tol):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  rng = np.random.default_rng(2)
  A = torch.tensor(_spd(rng, 512, 35, cond=1e2), dtype=dtype, device="cuda")
  b = torch.tensor(rng.normal(size=(512, 35)), dtype=dtype, device="cuda")
  chol.reset_counts()
  L = chol.chol_factor(A)
  x = chol.chol_solve(L, b)
  xf = chol.chol_factor_solve(A, b)
  torch.cuda.synchronize()
  assert chol.LAUNCHES == {
    "chol_factor": 1, "chol_solve": 1, "chol_factor_solve": 1, "newton_direction": 0,
    "newton_direction_cone": 0,
  }
  Lp = chol.chol_factor_plain(A)
  xp = chol.chol_solve_plain(Lp, b)
  assert _rel(L.cpu().numpy(), Lp.cpu().numpy()) < tol
  assert _rel(x.cpu().numpy(), xp.cpu().numpy()) < tol
  assert _rel(xf.cpu().numpy(), xp.cpu().numpy()) < tol
  bad = A.clone()
  bad[0, 3, 3] = -1.0
  Lb = chol.chol_factor(bad)
  assert torch.isnan(Lb[0]).sum() == 35 * 36 // 2 and torch.isfinite(Lb[1:]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 35, 64])
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card_for_every_order(n, dtype, tol):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  rng = np.random.default_rng(n)
  batch = 4 * 37 + 3  # not a multiple of the matrices per block
  A = torch.tensor(_spd(rng, batch, n, cond=1e2), dtype=dtype, device="cuda")
  b = torch.tensor(rng.normal(size=(batch, n)), dtype=dtype, device="cuda")
  L = chol.chol_factor(A)
  x = chol.chol_solve(L, b)
  xf = chol.chol_factor_solve(A, b)
  torch.cuda.synchronize()
  Lp = chol.chol_factor_plain(A)
  xp = chol.chol_solve_plain(Lp, b)
  assert _rel(L.cpu().numpy(), Lp.cpu().numpy()) < tol
  assert torch.all(torch.triu(L, 1) == 0)
  assert _rel(x.cpu().numpy(), xp.cpu().numpy()) < tol
  assert _rel(xf.cpu().numpy(), xp.cpu().numpy()) < tol
  bad = A.clone()
  bad[-1, n // 2, n // 2] = -1.0  # a non-positive pivot in the last matrix
  Lb, xb = chol.chol_factor(bad), chol.chol_factor_solve(bad, b)
  lower = torch.ones(n, n, dtype=torch.bool, device="cuda").tril()
  assert torch.equal(torch.isnan(Lb[-1]), lower) and torch.all(Lb[-1][~lower] == 0)
  assert torch.isfinite(Lb[:-1]).all()
  assert torch.isnan(xb[-1]).all() and torch.isfinite(xb[:-1]).all()
