"""csrc/newton_iter.cu's logic on the CPU, in the warp emulator
(tools/warp_emu: the source built with g++ against a host emulation of the
warp primitives it uses, each block run as 32 threads), called through
kernels/newton.py's own launch code on CPU tensors, in float64:

* every entry point against its plain version within 1e-12 relative (the
  acceptances and the warm starts' choices equal) on the seeded problems of
  EMU_CASES: every row class, cone dims 3, 4 and 6 with and without the
  safeguard, active counts at the register cap, worlds past it and past the
  cone rows' shared cap, more than 32 active slots, nv 64, no row active,
  warm starts that win, lose, equal a0 or hold a NaN;
* the gradient, w and blocks (and the forces) the warm start and a
  linesearch launch return at their point bitwise equal to
  newton_gradient's there;
* w exactly 0 on every row no launch lists after the list's build (by the
  warm start, or by newton_gradient) and three linesearches, from a buffer
  filled with NaN;
* a step that rounds to x not taken, and a NaN direction, as the plain
  versions do.

It says nothing of what nvcc accepts or of speed (the card tests in
tests/test_torch_newton_iter.py do). Skipped only where g++ is missing.
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from mjlab_tpu_torch.kernels import newton
from tests.test_torch_newton_iter import (
  EMU_CASES, LS_STEPS, PLAIN, inactive_weights_after_iterations,
  linesearch_gradient_differences, linesearch_plain, outputs, problem,
)

ROOT = Path(__file__).resolve().parents[1]


def _run_module():
  spec = importlib.util.spec_from_file_location("warp_emu_run", ROOT / "tools/warp_emu/run.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
  """The wrappers' kernel paths on the emulated library (built once)."""
  if shutil.which("g++") is None:
    pytest.skip("g++ is missing: the warp emulator is built with it")
  run = _run_module()
  lib = run.build(tmp_path_factory.mktemp("warp_emu"))
  saved = newton._fn
  newton._fn = run.entry_points(lib)
  yield run.KERNELS
  newton._fn = saved


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_entry_points_match_plain_in_emulation(case, emu):
  args, kw = EMU_CASES[case]
  prob = problem(*args, **kw)
  newton.reset_counts()
  got = outputs(*prob, emu)
  ls = 2 if prob[0].layout is not None else 1
  assert newton.LAUNCHES == {"warm_start": 1, "newton_gradient": 2, "newton_linesearch": 2 * ls}
  want = outputs(*prob, PLAIN)
  for k, g in got.items():
    w = want[k]
    if k.startswith("improved"):
      assert torch.equal(g, w), k
      continue
    assert torch.equal(torch.isnan(g), torch.isnan(w)), f"{k}: NaN pattern"
    ok = ~torch.isnan(w)
    if ok.any():
      err = (g - w)[ok].abs().max().item() / max(1.0, w[ok].abs().max().item())
      assert err <= 1e-12, (k, err)


@pytest.mark.parametrize("case", ["pyramidal", "equality and friction loss, nv 35",
                                  "cone dims 3, 4, 6", "active counts 127-129 (the cap)",
                                  "more than 32 slots, past both caps", "warm start wins"])
def test_linesearch_gradient_is_newton_gradient_bitwise_in_emulation(case, emu):
  args, kw = EMU_CASES[case]
  assert not linesearch_gradient_differences(*problem(*args, **kw), emu)


@pytest.mark.parametrize("first", ["warm_start", "gradient"])
@pytest.mark.parametrize("case", ["cone dims 3, 4, 6", "more than 32 slots, past both caps"])
def test_w_is_zero_on_inactive_rows_after_iterations_in_emulation(case, first, emu):
  args, kw = EMU_CASES[case]
  rows, x, p, ws = problem(*args, **kw)
  w = inactive_weights_after_iterations(rows, x, 0.1 * p, ws, emu, first)
  assert w.numel() and torch.equal(w, torch.zeros_like(w))


def test_a_step_that_leaves_x_as_it_is_ties_in_emulation(emu):
  rows, x, p, _ = problem(15, 4, 10, 40, ne=1, nf=2, cds=(3, 4))
  p = p * 1e-30
  grad = emu["gradient"](rows, x)[0]
  for sg in (False, True):
    xo, _, improved, (g, _, _) = emu["linesearch"](rows, x, p, LS_STEPS, sg)
    assert not improved.any() and torch.equal(xo, x) and torch.equal(g, grad)


def test_a_nan_direction_in_emulation(emu):
  rows, x, p, ws = problem(12, 4, 10, 40, ne=1, nf=2, cds=(3, 4))
  p[1, 3] = float("nan")
  emu["warm_start"](rows, ws)
  for sg in (False, True):
    xo, _, improved, (g, _, _) = emu["linesearch"](rows, x, p, LS_STEPS, sg)
    xp, _, ip, (gp, _, _) = linesearch_plain(rows, x, p, LS_STEPS, sg)
    assert torch.equal(torch.isnan(xo), torch.isnan(xp)) and torch.equal(improved, ip)
    assert torch.equal(torch.isnan(g), torch.isnan(gp))
    if not sg:
      assert torch.equal(xo[1], x[1])
