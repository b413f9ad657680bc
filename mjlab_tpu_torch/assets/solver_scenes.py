"""Small scenes of the solver surface: equality constraints, friction loss, a
limited tendon, torsional and rolling friction, the elliptic cone, CG,
Euler and RK4 (the JAX package's physics test scenes, and one limited fixed
tendon).

Each scene's MJCF is kept here and its compile is committed as
`solver/<name>.npz` (`assets.save_model_npz`), so that a host without
`mujoco` can load it (`load(name)`); `tests/test_torch_solver_scenes.py`
checks that each file is fresh and says how to regenerate them. A scene's
`qvel` is the initial velocity its JAX test gives, `opt` the option edits
its test makes after compiling (applied by `load`), and `cones` the cones
it runs under.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from mjlab_tpu_torch.physics.types import mjtCone

DIR = Path(__file__).parent / "solver"

# Both engines compare converged optima: many iterations, no early exit.
_CONVERGED = {"iterations": 50, "ls_iterations": 50, "tolerance": 0.0, "ls_tolerance": 0.0}


@dataclasses.dataclass(frozen=True)
class SolverScene:
  xml: str
  qvel: tuple[float, ...]
  opt: dict = dataclasses.field(default_factory=dict)
  cones: tuple[int, ...] = (mjtCone.mjCONE_PYRAMIDAL,)

  def path(self, name: str) -> Path:
    return DIR / f"{name}.npz"


_CAPSULE_ARM = """<geom type="capsule" fromto="0 0 0 {x} 0 0" size="0.03" density="800"
            contype="0" conaffinity="0"/>"""

SCENES: dict[str, SolverScene] = {
  "connect_fourbar": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1"><joint name="ja" type="hinge" axis="0 1 0"/>
      """ + _CAPSULE_ARM.format(x=0.4) + """</body>
    <body name="b" pos="0.8 0 1"><joint name="jb" type="hinge" axis="0 1 0"/>
      """ + _CAPSULE_ARM.format(x=-0.4) + """</body>
  </worldbody>
  <equality><connect body1="a" body2="b" anchor="0.4 0 0"/></equality>
</mujoco>""", (0.8, -0.5)),
  "connect_sites": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1"><joint name="ja" type="hinge" axis="0 1 0"/>
      """ + _CAPSULE_ARM.format(x=0.4) + """
      <site name="s1" pos="0.4 0 0.05"/></body>
    <body name="b" pos="0.8 0 1"><joint name="jb" type="hinge" axis="0 1 0"/>
      """ + _CAPSULE_ARM.format(x=-0.4) + """
      <site name="s2" pos="-0.4 0 -0.02"/></body>
  </worldbody>
  <equality><connect site1="s1" site2="s2"/></equality>
</mujoco>""", (0.8, -0.5)),
  "weld_pair": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1" density="600"/></body>
    <body name="b" pos="0.5 0 1"><freejoint/><geom type="box" size="0.08 0.08 0.08" density="600"/></body>
  </worldbody>
  <equality><weld body1="a" body2="b" torquescale="0.7"/></equality>
</mujoco>""", (0.3, -0.2, 0.4, 0.5, -0.6, 0.2, -0.1, 0.3, 0.1, -0.4, 0.2, 0.6)),
  "weld_sites": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1"><freejoint/>
      <geom type="box" size="0.1 0.1 0.1" density="600"/>
      <site name="s1" pos="0.12 0 0.03" quat="0.92 0.2 0.33 0"/></body>
    <body name="b" pos="0.21 -0.02 1.03"><freejoint/>
      <geom type="box" size="0.08 0.08 0.08" density="600"/>
      <site name="s2" pos="-0.09 0.02 0" quat="0.92 0.2 0.33 0"/></body>
  </worldbody>
  <equality><weld site1="s1" site2="s2" torquescale="0.6"/></equality>
</mujoco>""", (0.3, -0.2, 0.4, 0.5, -0.6, 0.2, -0.1, 0.3, 0.1, -0.4, 0.2, 0.6)),
  "joint_coupling": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1"><joint name="ja" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03"/>
      <body name="b" pos="0.4 0 0"><joint name="jb" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body>
    </body>
  </worldbody>
  <equality><joint joint1="jb" joint2="ja" polycoef="0.1 0.5 -0.2 0.05 0"/></equality>
</mujoco>""", (1.2, -0.4)),
  "tendon_coupling": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1"><joint name="a" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" contype="0" conaffinity="0"/>
      <body pos="0.3 0 0"><joint name="b" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03" contype="0" conaffinity="0"/></body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1"><joint joint="a" coef="0.6"/><joint joint="b" coef="0.3"/></fixed>
    <fixed name="t2"><joint joint="b" coef="1.0"/></fixed>
  </tendon>
  <equality><tendon tendon1="t1" tendon2="t2" polycoef="0.05 0.4 -0.1 0 0"/></equality>
</mujoco>""", (1.0, -0.6)),
  "connect_with_contact": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1"/>
    <body name="a" pos="0 0 0.3"><freejoint/><geom type="sphere" size="0.1" density="500"/></body>
    <body name="b" pos="0.3 0 0.3"><freejoint/><geom type="sphere" size="0.08" density="500"/></body>
  </worldbody>
  <equality><connect body1="a" body2="b" anchor="0.15 0 0"/></equality>
</mujoco>""", (0.2, 0, -0.5, 0.1, -0.2, 0.3, 0, 0, -0.5, 0, 0, 0)),
  "frictionloss": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint type="hinge" axis="0 1 0" frictionloss="0.4" damping="0.01"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04" contype="0" conaffinity="0"/>
    </body>
  </worldbody></mujoco>""", (1.5,)),
  "tendon_limit": SolverScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1"><joint name="a" type="hinge" axis="0 1 0" damping="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" contype="0" conaffinity="0"/>
      <body pos="0.3 0 0"><joint name="b" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03" contype="0" conaffinity="0"/></body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t" limited="true" range="-0.3 0.4"><joint joint="a" coef="0.8"/>
      <joint joint="b" coef="-0.5"/></fixed>
  </tendon>
</mujoco>""", (1.5, -2.0)),
  "cg_box": SolverScene("""
<mujoco><option timestep="0.002" solver="CG" iterations="50" ls_iterations="25"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1"/>
    <body pos="0 0 0.1" euler="2 1 0"><freejoint/>
      <geom type="box" size="0.1 0.08 0.06"/></body>
  </worldbody></mujoco>""", (0.1, 0, -0.4, 0.2, 0.3, -0.1)),
  "spinner_condim4": SolverScene("""
<mujoco model="spinner">
  <option timestep="0.002" cone="pyramidal"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" friction="0.6 0.08 0.01"/>
    <body name="b" pos="0 0 0.0999">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1" density="700"
            friction="0.6 0.08 0.01" condim="4"/>
    </body>
  </worldbody>
</mujoco>""", (0.8, 0.0, 0.0, 3.0, 0.0, 6.0), _CONVERGED,
    (mjtCone.mjCONE_PYRAMIDAL, mjtCone.mjCONE_ELLIPTIC)),
  "spinner_condim6": SolverScene("""
<mujoco model="spinner">
  <option timestep="0.002" cone="pyramidal"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" friction="0.6 0.08 0.01"/>
    <body name="b" pos="0 0 0.0999">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1" density="700"
            friction="0.6 0.08 0.01" condim="6"/>
    </body>
  </worldbody>
</mujoco>""", (0.8, 0.0, 0.0, 3.0, 0.0, 6.0), _CONVERGED,
    (mjtCone.mjCONE_PYRAMIDAL, mjtCone.mjCONE_ELLIPTIC)),
  "puck": SolverScene("""
<mujoco model="slide">
  <option timestep="0.002" cone="elliptic" impratio="1"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" friction="0.6 0.01 0.002"/>
    <body name="puck" pos="0 0 0.0999">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.1" density="800"
            friction="0.6 0.01 0.002"/>
    </body>
  </worldbody>
</mujoco>""", (1.5, 0.4, 0.0, 0.0, 0.0, 2.0), _CONVERGED, (mjtCone.mjCONE_ELLIPTIC,)),
  "humanoidish_euler": SolverScene("""
<mujoco>
  <option gravity="0 0 -9.81" timestep="0.002" integrator="Euler"/>
  <worldbody>
    <body name="torso" pos="0 0 1">
      <freejoint/>
      <geom type="capsule" fromto="0 0 -0.2 0 0 0.2" size="0.08" contype="0" conaffinity="0"/>
      <site name="imu" pos="0.02 0.01 0.05"/>
      <body pos="0.1 0 -0.2" quat="0.92 0.38 0 0">
        <joint type="hinge" axis="0 1 0" damping="0.5" armature="0.03"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.05" contype="0" conaffinity="0"/>
        <body pos="0 0 -0.3">
          <joint type="hinge" axis="1 0 0" damping="0.2" armature="0.01"/>
          <geom type="sphere" size="0.06" contype="0" conaffinity="0"/>
        </body>
      </body>
      <body pos="-0.1 0 -0.2">
        <joint type="hinge" axis="0 1 0" damping="0.5" armature="0.03"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.35" size="0.05" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <sensor>
    <gyro site="imu"/>
    <velocimeter site="imu"/>
    <accelerometer site="imu"/>
    <subtreeangmom body="torso"/>
  </sensor>
</mujoco>""", (0.2, -0.1, 0.3, 0.4, -0.2, 0.1, 0.5, -0.4, 0.3)),
  "pendulum_rk4": SolverScene("""
<mujoco><option timestep="0.004" integrator="RK4"/>
  <worldbody>
    <body pos="0 0 1"><joint name="j" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"
            contype="0" conaffinity="0"/>
      <body pos="0.4 0 0"><joint type="hinge" axis="1 0 0" damping="0.02"/>
        <geom type="capsule" fromto="0 0 0 0 0.25 0" size="0.03"
              contype="0" conaffinity="0"/></body>
    </body>
  </worldbody></mujoco>""", (1.5, -0.8)),
  "freefall_rk4": SolverScene("""
<mujoco><option timestep="0.002" integrator="RK4"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0.01 0.02 0.3"><freejoint/>
      <geom type="sphere" size="0.1" friction="0.7"/></body>
  </worldbody></mujoco>""", (0.0,) * 6),
}


def load(name: str, cone: int | None = None):
  """The scene's committed model (`load_model_npz`), its test's option
  edits applied, under `cone` if given."""
  from mjlab_tpu_torch.assets import load_model_npz

  sc = SCENES[name]
  m = load_model_npz(sc.path(name))
  for k, v in sc.opt.items():
    setattr(m.opt, k, v)
  if cone is not None:
    m.opt.cone = cone
  return m
