"""The port stands alone: importing it pulls in neither jax, mjlab_tpu nor
mujoco, and its own MuJoCo enum constants agree with mujoco's."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mjlab_tpu_torch.physics import types

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_out_jax_mjlab_tpu_and_mujoco():
  code = (
    "import json, sys\n"
    "import mjlab_tpu_torch, mjlab_tpu_torch.sim, mjlab_tpu_torch.physics\n"
    "import mjlab_tpu_torch.kernels.chol, mjlab_tpu_torch.kernels.build\n"
    "import mjlab_tpu_torch.assets\n"
    "m = mjlab_tpu_torch.assets.load_model_npz()\n"
    "print(json.dumps(sorted(k for k in sys.modules\n"
    "  if k.split('.')[0] in ('jax', 'jaxlib', 'mjlab_tpu', 'mujoco'))))\n"
  )
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  out = subprocess.run(
    [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
    text=True, timeout=120, check=True,
  )
  assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
  "enum",
  ["mjtJoint", "mjtGeom", "mjtSensor", "mjtObj", "mjtBias", "mjtGain",
   "mjtDyn", "mjtTrn", "mjtIntegrator", "mjtSolver", "mjtCone",
   "mjtDisableBit"],
)
def test_enum_constants_match_mujoco(enum):
  import mujoco

  ours = getattr(types, enum)
  theirs = getattr(mujoco, enum)
  names = [n for n in vars(ours) if n.startswith("mj")]
  assert names
  for n in names:
    assert getattr(ours, n) == int(getattr(theirs, n)), f"{enum}.{n}"
