"""Small scenes of the analytic plane–cylinder and plane–ellipsoid pairs and
of height fields against a sphere, a capsule, a box and a mesh hull (after
the JAX package's tests/test_physics_convex.py scenes).

Each scene's MJCF is kept here and its compile is committed as
`pairs/<name>.npz` (`assets.save_model_npz`), so that a host without
`mujoco` can load it (`load(name)`); `tests/test_torch_hfield.py` checks
that each file is fresh and says how to regenerate them. A scene's `qvel`
is the velocity its runs start from, at the model's qpos0; every body
starts a few millimetres into its ground, so that each pair's contacts are
active from the first substep.

`hfield` holds two height fields of different raster shapes (two
sub-groups of the narrowphase): a 10 x 8 ridged field under the sphere,
the capsule, the box and the mesh, and a 5 x 5 bowl under a second sphere.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

DIR = Path(__file__).parent / "pairs"


@dataclasses.dataclass(frozen=True)
class PairScene:
  xml: str
  qvel: tuple[float, ...] = ()

  def path(self, name: str) -> Path:
    return DIR / f"{name}.npz"


def _elevation(ncol: int, nrow: int, f) -> str:
  """An MJCF elevation attribute: f(x, y) on the raster, row-major (rows
  along y), rounded to 3 decimals."""
  x = np.linspace(-1.0, 1.0, ncol)
  y = np.linspace(-1.0, 1.0, nrow)
  z = np.asarray([[f(xi, yj) for xi in x] for yj in y])
  return " ".join(f"{v:.3f}" for v in z.ravel())


_RIDGES = _elevation(10, 8, lambda x, y: 0.5 + 0.3 * np.sin(2.5 * x) * np.cos(1.7 * y))
_BOWL = _elevation(5, 5, lambda x, y: 0.2 + 0.4 * (x * x + y * y))

_OPTION = '<option timestep="0.002" iterations="10" ls_iterations="20"/>'
# The bodies collide with the ground only (contype 1, conaffinity 0 against
# the ground's 1, 1), so that each scene holds only the pairs it is for.
_DEFAULT = '<default><geom contype="1" conaffinity="0"/></default>'
_GROUND = 'contype="1" conaffinity="1"'

SCENES: dict[str, PairScene] = {
  "plane_cylinder": PairScene(f"""
<mujoco>{_OPTION}{_DEFAULT}
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" {_GROUND} friction="0.9 0.01 0.001"/>
    <body name="tilted" pos="0 0 0.111" euler="35 20 0"><freejoint/>
      <geom type="cylinder" size="0.06 0.1" density="800"/></body>
    <body name="upright" pos="0.5 0.2 0.096"><freejoint/>
      <geom type="cylinder" size="0.08 0.1" density="800"/></body>
  </worldbody>
</mujoco>""", qvel=(0.3, -0.2, 0.0, 1.0, -0.5, 0.7, -0.1, 0.2, 0.0, 0.0, 0.0, 0.4)),
  "plane_ellipsoid": PairScene(f"""
<mujoco>{_OPTION}{_DEFAULT}
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" {_GROUND} friction="0.9 0.01 0.001"/>
    <body name="egg" pos="0 0 0.054" euler="25 -15 10"><freejoint/>
      <geom type="ellipsoid" size="0.09 0.07 0.05" density="800"/></body>
    <body name="flat" pos="0.4 0 0.046"><freejoint/>
      <geom type="ellipsoid" size="0.1 0.08 0.05" density="800"/></body>
  </worldbody>
</mujoco>""", qvel=(0.2, 0.1, 0.0, -0.6, 0.8, 0.3, 0.0, -0.3, 0.0, 0.5, 0.0, 0.0)),
  "hfield": PairScene(f"""
<mujoco>{_OPTION}{_DEFAULT}
  <asset>
    <hfield name="ridges" nrow="8" ncol="10" size="1.5 1.2 0.3 0.1" elevation="{_RIDGES}"/>
    <hfield name="bowl" nrow="5" ncol="5" size="0.5 0.5 0.2 0.1" elevation="{_BOWL}"/>
    <mesh name="octa" vertex="0.07 0 0  -0.07 0 0  0 0.06 0  0 -0.06 0  0 0 0.05  0 0 -0.05"/>
  </asset>
  <worldbody>
    <geom name="ridges" type="hfield" hfield="ridges" {_GROUND} friction="0.9 0.01 0.001"/>
    <geom name="bowl" type="hfield" hfield="bowl" pos="3 0 0" {_GROUND}/>
    <body name="ball" pos="-0.8 -0.5 0.113"><freejoint/>
      <geom type="sphere" size="0.08" density="800"/></body>
    <body name="rod" pos="0.6 -0.5 0.319" euler="80 10 0"><freejoint/>
      <geom type="capsule" size="0.04 0.15" density="800"/></body>
    <body name="brick" pos="-0.6 0.5 0.106" euler="10 -5 30"><freejoint/>
      <geom type="box" size="0.08 0.06 0.05" density="800"/></body>
    <body name="gem" pos="0.6 0.5 0.29" euler="0 15 45"><freejoint/>
      <geom type="mesh" mesh="octa" density="800"/></body>
    <body name="marble" pos="3.1 0.05 0.082"><freejoint/>
      <geom type="sphere" size="0.07" density="800"/></body>
  </worldbody>
</mujoco>""", qvel=(0.2, 0.1, 0.0, 0.0, 0.5, 0.0) * 5),
}


def load(name: str):
  """The scene's committed model (`load_model_npz`)."""
  from mjlab_tpu_torch.assets import load_model_npz

  return load_model_npz(SCENES[name].path(name))
