"""kernel_ab.py, the A/B timer of the Newton-direction, Cholesky, PGS,
Newton iteration and warm-start kernels' sources, on the CPU: the order in which it times versions, the
sources a version's directory gives it, the cases it is asked for, and
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


@pytest.mark.parametrize("args", [[], ["build/parent"], ["build/parent", "--cases", "pgs"],
                                  ["build/parent", "--cut", "build/nosweep", "--cases", "pgs",
                                   "newton"]])
def test_runs_nothing_without_a_card_or_a_directory(args):
  env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
  out = subprocess.run([sys.executable, "kernel_ab.py", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 2
  assert out.stdout == ""
  assert ("usage" if not args else "is_available() is false") in out.stderr


@pytest.mark.parametrize("argv, cases", [
  (["build/parent"], ["newton", "chol", "pgs", "newton_iter", "warm_start"]),
  (["build/parent", "--cases", "pgs"], ["pgs"]),
  (["build/parent", "--cases", "warm_start", "newton_iter"], ["warm_start", "newton_iter"]),
  (["build/parent", "--cut", "build/a", "--cut", "build/b", "--cases", "chol", "pgs"],
   ["chol", "pgs"]),
])
def test_cases_and_cuts_parse(argv, cases):
  args = kernel_ab.parse_args(argv)
  assert args.cases == cases
  assert args.dirs == [Path("build/parent")]
  assert [d.name for d in args.cut] == [a.split("/")[-1] for a in argv[2:] if "build/" in a
                                        and a != "build/parent"]


@pytest.mark.parametrize("argv", [["build/parent", "--cases", "sweep"], ["--cases", "pgs"]])
def test_refuses_an_unknown_case_or_no_directory(argv, capsys):
  with pytest.raises(SystemExit) as e:
    kernel_ab.parse_args(argv)
  assert e.value.code == 2
  assert "usage" in capsys.readouterr().err


@pytest.mark.parametrize("files, sources", [
  (["pgs.cu"], ["pgs"]),
  (["newton_dir.cu", "chol.cu"], ["chol"]),  # newton_dir.cu needs its chol_core.cuh
  (["newton_dir.cu", "chol_core.cuh", "chol.cu", "pgs.cu"], ["newton_dir", "chol", "pgs"]),
  (["newton_iter.cu"], ["newton_iter"]),
])
def test_a_version_joins_the_cases_of_the_sources_it_has(tmp_path, files, sources):
  for name in files:
    (tmp_path / name).write_text("// a source\n")
  assert kernel_ab.version_sources(tmp_path) == sources
  this = kernel_ab.version_sources(ROOT / "mjlab_tpu_torch" / "csrc")
  assert this == ["newton_dir", "chol", "pgs", "newton_iter"]
