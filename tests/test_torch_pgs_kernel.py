"""The PGS kernel's wrapper and plain version (kernels/pgs.py), and the
kernel (csrc/pgs.cu) against the plain version on the card.

Problems are seeded: M = X Xᵀ/n + 0.1 I and its Cholesky factor L, J and
a0 normal, aref normal, D uniform on the active rows and 0 on the others
(`pattern`: all, a fifth, none active, or a given count per world), and
the row classes of the solver's layout (equality rows unbounded,
friction-loss rows in [−fl, fl], the rest in [0, ∞), inactive rows
[0, 0]). On the CPU the wrapper takes the plain path and counts no launch;
the plain version forms b = J a0 − aref and qfrc = Jᵀf; rows inactive in a
world keep f = 0 there, bitwise, and change nothing. On the card the kernel
is held to the plain version, for f, u and qfrc: float64 within 1e-10
relative, float32 within max(1e-5 × scale, 4 × the plain float32 version's
own error against float64), NaN patterns equal; at G1's shapes (nv 35, 1699
rows), row counts that leave a 32-row chunk ragged, nv past one warp's 32
lanes, a grid of more worlds than the card holds at once, active counts
per world on both sides of the kernel's chunks and of its cap (CAP = 128
active rows: above it a world takes the u-based sweep), worlds below and
above the cap in one batch, and a NaN in one world's aref. This file
imports no JAX. On the card:
  python -m pytest --noconftest -m gpu tests/test_torch_pgs_kernel.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import pgs

ITERATIONS = 10


def problem(seed, batch, n, m, pattern="sparse", ne=3, nf=4):
  """L, J, a0, aref, D, lo, hi; `pattern` an int (or a list per world) is
  that many active rows per world at seeded positions."""
  rng = np.random.default_rng(seed)
  X = rng.normal(size=(batch, n, n))
  M = X @ np.swapaxes(X, -1, -2) / n + 0.1 * np.eye(n)
  L = np.linalg.cholesky(M)
  J = rng.normal(size=(batch, m, n))
  a0 = rng.normal(size=(batch, n))
  aref = rng.normal(size=(batch, m))
  D = rng.uniform(0.5, 20.0, size=(batch, m))
  if pattern == "sparse":
    D = np.where(rng.uniform(size=(batch, m)) < 0.2, D, 0.0)
  elif pattern == "zero":
    D = np.zeros((batch, m))
  elif pattern != "all":
    counts = [pattern] * batch if np.isscalar(pattern) else pattern
    keep = np.zeros((batch, m), dtype=bool)
    for w, k in enumerate(counts):
      keep[w, rng.choice(m, size=k, replace=False)] = True
    D = np.where(keep, D, 0.0)
  fl = rng.uniform(0.1, 1.0, size=(batch, m))
  row = np.arange(m)
  lo = np.where(row < ne, -np.inf, np.where(row < ne + nf, -fl, 0.0))
  hi = np.where(row < ne, np.inf, np.where(row < ne + nf, fl, np.inf))
  lo = np.where(D > 0, lo, 0.0)
  hi = np.where(D > 0, hi, 0.0)
  return L, J, a0, aref, D, lo, hi


def tensors(*arrays, dtype=torch.float64, device="cpu"):
  return tuple(torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
               for a in arrays)


def test_plain_skips_rows_inactive_everywhere_bitwise():
  """Rows inactive in every world change nothing, bitwise: their force
  stays 0 and the others' equal a problem without them."""
  L, J, a0, aref, D, lo, hi = problem(1, 4, 12, 40)
  D[:, 10:25] = 0.0
  lo[:, 10:25] = hi[:, 10:25] = 0.0
  f, u, qfrc = pgs.pgs_solve_plain(*tensors(L, J, a0, aref, D, lo, hi), ITERATIONS)
  keep = np.r_[0:10, 25:40]
  f2, u2, qfrc2 = pgs.pgs_solve_plain(*tensors(L, J[:, keep], a0, aref[:, keep], D[:, keep],
                                               lo[:, keep], hi[:, keep]), ITERATIONS)
  assert torch.equal(f[:, 10:25], torch.zeros_like(f[:, 10:25]))
  assert torch.allclose(f[:, keep], f2, rtol=0, atol=1e-13)
  assert torch.allclose(u, u2, rtol=0, atol=1e-13)
  assert torch.allclose(qfrc, qfrc2, rtol=0, atol=1e-12)


def test_plain_forces_stay_in_their_boxes():
  L, J, a0, aref, D, lo, hi = problem(2, 3, 9, 30, pattern="all")
  f, _, _ = pgs.pgs_solve_plain(*tensors(L, J, a0, aref, D, lo, hi), ITERATIONS)
  f = f.numpy()
  assert np.all(f >= lo - 1e-15) and np.all(f <= hi + 1e-15)
  assert np.any(f[:, :3] < 0)  # equality rows take either sign


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_forms_b_and_qfrc(dtype):
  """pgs_solve_plain's b = J a0 − aref gives the same f and u, bitwise, as
  the b-taking sweeps given that b; qfrc = Jᵀf."""
  L, J, a0, aref, D, lo, hi = args = tensors(*problem(10, 5, 11, 60), dtype=dtype)
  f, u, qfrc = pgs.pgs_solve_plain(*args, ITERATIONS)
  b = (J @ a0[..., None])[..., 0] - aref
  f0, u0 = pgs.pgs_sweeps_plain(L, J, D, b, lo, hi, ITERATIONS)
  assert torch.equal(f, f0) and torch.equal(u, u0)
  want = torch.einsum("bmn,bm->bn", J.double(), f.double())
  tol = (1e-12 if dtype == torch.float64 else 1e-5) * max(1.0, want.abs().max().item())
  torch.testing.assert_close(qfrc.double(), want, rtol=0, atol=tol)
  assert f.abs().max() > 1e-3


def test_plain_keeps_inactive_rows_zero_where_a_world_is_nan():
  """A NaN in one world's aref on an active row reaches that world's active
  rows, u and qfrc; its inactive rows keep f = 0 exactly (their box is
  [0, 0]), also rows active in other worlds; the other worlds are finite."""
  L, J, a0, aref, D, lo, hi = problem(11, 4, 9, 50)
  w = 2
  row = int(np.flatnonzero(D[w] > 0)[0])
  aref[w, row] = np.nan
  f, u, qfrc = pgs.pgs_solve_plain(*tensors(L, J, a0, aref, D, lo, hi), ITERATIONS)
  active = torch.tensor(D > 0)
  assert torch.isnan(f[w][active[w]]).all()
  assert torch.equal(f[w][~active[w]], torch.zeros_like(f[w][~active[w]]))
  assert (active[w] == 0).any() and active[:, ~active[w]].any()  # the case is exercised
  assert torch.isnan(u[w]).all() and torch.isnan(qfrc[w]).all()
  others = [k for k in range(4) if k != w]
  assert torch.isfinite(f[others]).all() and torch.isfinite(u[others]).all()


def test_cpu_wrapper_takes_plain_path_and_counts_nothing():
  args = tensors(*problem(3, 2, 7, 11))
  pgs.reset_counts()
  out = pgs.pgs_solve(*args, ITERATIONS)
  ref = pgs.pgs_solve_plain(*args, ITERATIONS)
  assert all(torch.equal(a, b) for a, b in zip(out, ref))
  assert pgs.LAUNCHES["pgs_solve"] == 0


@pytest.mark.parametrize("n, m", [(35, 1699), (35, 40), (7, 3), (50, 129), (64, 200), (35, 65),
                                  (35, 96), (20, 33)])
def test_scratch_holds_both_branches(n, m):
  """W holds the u-based branch's rows (J's size) and the dual path's w_c
  rows (the compiled width rounded up to 4, for min(m, CAP) rounded up to
  32 rows), in whole 16-byte groups; AR the dual on the rows swept (the
  active ones rounded up to 4)."""
  ws, ars = pgs.scratch_elems(n, m)
  capr = min(pgs.CAP, -(-m // 32) * 32)
  width = -(-pgs.instance_n(n) // 4) * 4
  assert ws >= m * n and ws >= capr * width and ws % 4 == 0
  assert capr % 32 == 0 and capr <= pgs.CAP and pgs.instance_n(n) >= n
  for na in range(1, min(m, pgs.CAP) + 1):
    assert (-(-na // 4) * 4) ** 2 <= ars


def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _check(arrays, dtype, iterations=ITERATIONS):
  """The kernel against the plain version on these arrays; returns its
  outputs."""
  args = tensors(*arrays, dtype=dtype, device="cuda")
  pgs.reset_counts()
  out = pgs.pgs_solve(*args, iterations)
  torch.cuda.synchronize()
  assert pgs.LAUNCHES["pgs_solve"] == 1
  ref64 = pgs.pgs_solve_plain(*tensors(*arrays, device="cuda"), iterations)
  plain = pgs.pgs_solve_plain(*args, iterations)
  for what, got, want, p in zip(("f", "u", "qfrc"), out, ref64, plain):
    assert torch.equal(torch.isnan(got), torch.isnan(p)), f"{what}: NaN pattern"
    ok = ~torch.isnan(p)
    err = (got.double() - want)[ok].abs().max().item() if ok.any() else 0.0
    scale = max(1.0, want[ok].abs().max().item()) if ok.any() else 1.0
    if dtype == torch.float64:
      assert err <= 1e-10 * scale, (what, err)
    else:
      ref_err = (p.double() - want)[ok].abs().max().item() if ok.any() else 0.0
      assert err <= max(1e-5 * scale, 4 * ref_err), (what, err, ref_err)
  inactive = args[4] <= 0
  f = out[0]
  assert torch.equal(f[inactive], torch.zeros_like(f[inactive]))
  return out


@pytest.mark.gpu
@pytest.mark.parametrize("n, m", [(35, 1699), (35, 67), (32, 33), (33, 100), (50, 129),
                                  (7, 1), (64, 40)])
@pytest.mark.parametrize("pattern", ["all", "sparse", "zero"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(n, m, pattern, dtype):
  _card()
  _check(problem(6, 37, n, m, pattern), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("count", [0, 1, 31, 32, 33, 127, 128, 129, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_active_counts_around_chunks_and_cap_on_card(count, dtype):
  """Every world with `count` active rows of 400 at G1's nv: 0 to 128 take
  the dual path (a ragged last chunk at 1, 33, 127), 129 and 300 the
  u-based sweep."""
  _card()
  _check(problem(12, 9, 35, 400, count), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_mixes_worlds_below_and_above_the_cap_on_card(dtype):
  _card()
  counts = [0, 5, 40, 113, 128, 129, 150, 260, 64, 97, 1, 200]
  _check(problem(13, len(counts), 35, 300, counts), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("count", [40, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_nan_in_one_worlds_aref_on_card(count, dtype):
  """A NaN in one world's aref on an active row: the same f, u and qfrc
  entries are NaN as in the plain version (that world's active rows and all
  its dofs), its inactive rows stay 0 and the other worlds are untouched;
  on the dual path (40 active rows) and the u-based one (129)."""
  _card()
  arrays = problem(14, 6, 35, 300, count)
  w = 4
  arrays[3][w, int(np.flatnonzero(arrays[4][w] > 0)[count // 2])] = np.nan
  f, u, qfrc = _check(arrays, dtype)
  assert torch.isnan(f[w]).any() and torch.isnan(u[w]).all() and torch.isnan(qfrc[w]).all()
  assert torch.isfinite(torch.cat([f[:w], f[w + 1:]])).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_batch_past_one_wave_on_card(dtype):
  """More worlds than the card holds at once (132 SMs x 32 one-warp
  blocks), an odd tail, and rows whose active counts differ widely."""
  _card()
  _check(problem(7, 4225 + 2, 35, 71, "sparse"), dtype, iterations=3)


@pytest.mark.gpu
def test_kernel_zero_iterations_on_card():
  """No sweep: f, u and qfrc are 0."""
  _card()
  f, u, qfrc = _check(problem(8, 5, 35, 50, "all"), torch.float64, iterations=0)
  assert not f.any() and not u.any() and not qfrc.any()


@pytest.mark.gpu
def test_g1_f32_instance_spills_nothing_on_card():
  """At G1's nv in f32 the kernel spills nothing and keeps the 12 worlds
  per SM its launch bounds ask for resident."""
  _card()
  cfg = pgs.launch_config(torch.float32, 35)
  assert cfg["N"] == 35 and cfg["spill_bytes"] == 0, cfg
  assert cfg["worlds_per_sm"] >= 12, cfg


@pytest.mark.gpu
def test_wrapper_refuses_bad_inputs_on_card():
  _card()
  L, J, a0, aref, D, lo, hi = tensors(*problem(9, 3, 35, 20), device="cuda")
  with pytest.raises(ValueError, match="shape"):
    pgs.pgs_solve(L, J, a0, aref, D[:, :5].contiguous(), lo, hi, 3)
  with pytest.raises(ValueError, match="shape"):
    pgs.pgs_solve(L, J, a0[:, :5].contiguous(), aref, D, lo, hi, 3)
  with pytest.raises(ValueError, match="contiguous"):
    pgs.pgs_solve(L, J.transpose(0, 1).contiguous().transpose(0, 1), a0, aref, D, lo, hi, 3)
  with pytest.raises(ValueError, match="device and dtype"):
    pgs.pgs_solve(L, J.float(), a0, aref, D, lo, hi, 3)
  with pytest.raises(ValueError, match="n <= 64"):
    big = torch.eye(65, dtype=torch.float64, device="cuda").expand(3, 65, 65).contiguous()
    pgs.pgs_solve(big, J, a0, aref, D, lo, hi, 3)
