"""kernel_ab.py, the A/B timer of the Newton-direction and Cholesky
kernels' sources, on the CPU: the order in which it times versions, and
that it runs nothing without a card."""

from __future__ import annotations

import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import kernel_ab  # noqa: E402


@pytest.mark.parametrize("others", [[], ["parent"], ["parent", "variant"]])
def test_turns_time_each_version_four_times_around_this(others):
  order = kernel_ab.turns(others + ["this"])
  assert Counter(order) == {name: 4 for name in others + ["this"]}
  half = order[: len(order) // 2]
  assert half == half[::-1]  # the others before and after this, in mirror order
  assert half[len(half) // 2 - 1: len(half) // 2 + 1] == ["this", "this"]


@pytest.mark.parametrize("args", [[], ["build/parent"]])
def test_runs_nothing_without_a_card_or_a_directory(args):
  env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
  out = subprocess.run([sys.executable, "kernel_ab.py", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 2
  assert out.stdout == ""
  assert ("usage" if not args else "is_available() is false") in out.stderr
