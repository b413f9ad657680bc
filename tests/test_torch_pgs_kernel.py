"""The PGS kernel's wrapper and plain version (kernels/pgs.py), and the
kernel (csrc/pgs.cu) against the plain version on the card.

Problems are seeded: M = X Xᵀ/n + 0.1 I and its Cholesky factor L, J
normal, D uniform on the active rows and 0 on the others (`pattern`: all,
a fifth, none active), b normal, and the row classes of the solver's
layout (equality rows unbounded, friction-loss rows in [−fl, fl], the rest
in [0, ∞), inactive rows [0, 0]). On the CPU the wrapper takes the plain
path and counts no launch; rows inactive in every world are skipped and
change nothing, bitwise. On the card the kernel is held to the plain
version: float64 within 1e-10 relative, float32 within max(1e-5 × scale,
4 × the plain float32 version's own error against float64), at G1's
shapes (nv 35, 1699 rows), row counts that leave a 32-row chunk ragged,
nv past one warp's 32 lanes, and a grid of more worlds than the card holds
at once. This file imports no JAX. On the card:
  python -m pytest --noconftest -m gpu tests/test_torch_pgs_kernel.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import pgs

ITERATIONS = 10


def problem(seed, batch, n, m, pattern="sparse", ne=3, nf=4):
  rng = np.random.default_rng(seed)
  X = rng.normal(size=(batch, n, n))
  M = X @ np.swapaxes(X, -1, -2) / n + 0.1 * np.eye(n)
  L = np.linalg.cholesky(M)
  J = rng.normal(size=(batch, m, n))
  D = rng.uniform(0.5, 20.0, size=(batch, m))
  if pattern == "sparse":
    D = np.where(rng.uniform(size=(batch, m)) < 0.2, D, 0.0)
  elif pattern == "zero":
    D = np.zeros((batch, m))
  b = rng.normal(size=(batch, m))
  fl = rng.uniform(0.1, 1.0, size=(batch, m))
  row = np.arange(m)
  lo = np.where(row < ne, -np.inf, np.where(row < ne + nf, -fl, 0.0))
  hi = np.where(row < ne, np.inf, np.where(row < ne + nf, fl, np.inf))
  lo = np.where(D > 0, lo, 0.0)
  hi = np.where(D > 0, hi, 0.0)
  return L, J, D, b, lo, hi


def tensors(*arrays, dtype=torch.float64, device="cpu"):
  return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
               for a in arrays)


def test_plain_skips_rows_inactive_everywhere_bitwise():
  """Rows inactive in every world change nothing, bitwise: their force
  stays 0 and the others' equal a problem without them."""
  L, J, D, b, lo, hi = problem(1, 4, 12, 40)
  D[:, 10:25] = 0.0
  lo[:, 10:25] = hi[:, 10:25] = 0.0
  f, u = pgs.pgs_solve_plain(*tensors(L, J, D, b, lo, hi), ITERATIONS)
  keep = np.r_[0:10, 25:40]
  f2, u2 = pgs.pgs_solve_plain(*tensors(L, J[:, keep], D[:, keep], b[:, keep], lo[:, keep],
                                        hi[:, keep]), ITERATIONS)
  assert torch.equal(f[:, 10:25], torch.zeros_like(f[:, 10:25]))
  assert torch.allclose(f[:, keep], f2, rtol=0, atol=1e-13)
  assert torch.allclose(u, u2, rtol=0, atol=1e-13)


def test_plain_forces_stay_in_their_boxes():
  L, J, D, b, lo, hi = problem(2, 3, 9, 30, pattern="all")
  f, _ = pgs.pgs_solve_plain(*tensors(L, J, D, b, lo, hi), ITERATIONS)
  f = f.numpy()
  assert np.all(f >= lo - 1e-15) and np.all(f <= hi + 1e-15)
  assert np.any(f[:, :3] < 0)  # equality rows take either sign


def test_cpu_wrapper_takes_plain_path_and_counts_nothing():
  args = tensors(*problem(3, 2, 7, 11))
  pgs.reset_counts()
  f, u = pgs.pgs_solve(*args, ITERATIONS)
  f0, u0 = pgs.pgs_solve_plain(*args, ITERATIONS)
  assert torch.equal(f, f0) and torch.equal(u, u0)
  assert pgs.LAUNCHES["pgs_solve"] == 0


def _check_on_card(seed, batch, n, m, pattern, dtype, iterations=ITERATIONS):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  arrays = problem(seed, batch, n, m, pattern)
  args = tensors(*arrays, dtype=dtype, device="cuda")
  pgs.reset_counts()
  f, u = pgs.pgs_solve(*args, iterations)
  torch.cuda.synchronize()
  assert pgs.LAUNCHES["pgs_solve"] == 1
  f64, u64 = pgs.pgs_solve_plain(*tensors(*arrays, device="cuda"), iterations)
  for got, want in ((f, f64), (u, u64)):
    err = (got.double() - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if dtype == torch.float64:
      assert err <= 1e-10 * scale, err
    else:
      plain = pgs.pgs_solve_plain(*args, iterations)[0 if got is f else 1]
      ref_err = (plain.double() - want).abs().max().item()
      assert err <= max(1e-5 * scale, 4 * ref_err), (err, ref_err)
  inactive = args[2] <= 0
  assert torch.equal(f[inactive], torch.zeros_like(f[inactive]))


@pytest.mark.gpu
@pytest.mark.parametrize("n, m", [(35, 1699), (35, 67), (32, 33), (33, 100), (50, 129),
                                  (7, 1), (64, 40)])
@pytest.mark.parametrize("pattern", ["all", "sparse", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(n, m, pattern, dtype):
  _check_on_card(6, 37, n, m, pattern, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_batch_past_one_wave_on_card(dtype):
  """More worlds than the card holds at once (132 SMs x 32 one-warp
  blocks), an odd tail, and rows whose active counts differ widely."""
  _check_on_card(7, 4225 + 2, 35, 71, "sparse", dtype, iterations=3)


@pytest.mark.gpu
def test_kernel_zero_iterations_on_card():
  """No sweep: f and u are 0."""
  _check_on_card(8, 5, 35, 50, "all", torch.float64, iterations=0)


@pytest.mark.gpu
def test_wrapper_refuses_bad_inputs_on_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
  L, J, D, b, lo, hi = tensors(*problem(9, 3, 35, 20), device="cuda")
  with pytest.raises(ValueError, match="shape"):
    pgs.pgs_solve(L, J, D[:, :5].contiguous(), b, lo, hi, 3)
  with pytest.raises(ValueError, match="contiguous"):
    pgs.pgs_solve(L, J.transpose(0, 1).contiguous().transpose(0, 1), D, b, lo, hi, 3)
  with pytest.raises(ValueError, match="device and dtype"):
    pgs.pgs_solve(L, J.float(), D, b, lo, hi, 3)
  with pytest.raises(ValueError, match="n <= 64"):
    big = torch.eye(65, dtype=torch.float64, device="cuda").expand(3, 65, 65).contiguous()
    pgs.pgs_solve(big, J, D, b, lo, hi, 3)
