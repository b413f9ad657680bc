"""Small scenes of the actuation and tendon surface: activation dynamics and
muscles, the inertia-box fluid model, spatial tendons (site chains,
pulleys, sphere and cylinder wrapping) and the PGS solver (the JAX
package's physics test scenes, and a small musculoskeletal arm).

Each scene's MJCF is kept here and its compile is committed as
`muscle/<name>.npz` (`assets.save_model_npz`), so that a host without
`mujoco` can load it (`load(name)`); `tests/test_torch_muscle_scenes.py`
checks that each file is fresh and says how to regenerate them. A scene's
`state(model)` is the (qpos, qvel) its JAX test starts from, `ctrl(k, nu)`
the control it applies before step k (None: no control), and
`integrators` the integrators its JAX test runs (the npz holds the
first; `load` sets another).

The arm (`muscle_arm`) has two hinges, four muscles on spatial tendons
(two around a cylinder at the shoulder with sidesites, two around a sphere
at the elbow), a fifth muscle on a two-branch pulley tendon across both
joints, a filterexact actuator and an integrator (`intvelocity`) actuator,
both with actrange, under density, viscosity and wind. Its wrap geoms do
not collide (a colliding cylinder would meet the plane–cylinder pair,
which the port refuses).

`HOPPER_FILTER` is the compile of the JAX package's filter-actuated hopper
env (tests/test_physics_actdyn.py `_make_filter_env`), and
`hopper_filter_env_cfg` the port's cfg of that env, which names no spec.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np

from mjlab_tpu_torch.physics.types import mjtIntegrator

DIR = Path(__file__).parent / "muscle"
HOPPER_FILTER = Path(__file__).parent / "hopper_filter.npz"

_EULER, _IMPLICITFAST, _RK4 = (
  mjtIntegrator.mjINT_EULER, mjtIntegrator.mjINT_IMPLICITFAST, mjtIntegrator.mjINT_RK4)


def _at_rest(m):
  return np.asarray(m.qpos0, dtype=np.float64).copy(), np.zeros(m.nv)


def _velocity(*qvel: float):
  def state(m):
    qpos, v = _at_rest(m)
    v[: len(qvel)] = qvel
    return qpos, v
  return state


def _actdyn_state(m):
  """tests/test_physics_actdyn.py: qpos0 + 0.2 N(0, 1), qvel 0.3 N(0, 1)."""
  rng = np.random.default_rng(11)
  return m.qpos0 + 0.2 * rng.standard_normal(m.nq), 0.3 * rng.standard_normal(m.nv)


def _fluid_state(m):
  """tests/test_physics_fluid.py: the torso moved by 0.1 N(0, 1), qvel 0.8 N(0, 1)."""
  rng = np.random.default_rng(9)
  qpos = np.asarray(m.qpos0, dtype=np.float64).copy()
  qpos[:3] += 0.1 * rng.standard_normal(3)
  return qpos, 0.8 * rng.standard_normal(m.nv)


def _pgs_state(m):
  qpos, v = _at_rest(m)
  v[:7] = [0.1, 0, -0.4, 0.2, 0.3, -0.1, 1.0]
  return qpos, v


def _phases(*levels: float, every: int = 10):
  """A piecewise-constant control: `levels` in turn, `every` steps each."""
  def ctrl(k, nu):
    return np.full(nu, levels[min(k // every, len(levels) - 1)])
  return ctrl


def _sines(k, nu):
  return np.sin(0.07 * k + np.arange(nu))


def _arm_ctrl(k, nu):
  return 0.5 + 0.5 * np.sin(0.05 * k + 0.9 * np.arange(nu))


@dataclasses.dataclass(frozen=True)
class MuscleScene:
  xml: str
  state: Callable = _at_rest
  ctrl: Callable | None = None
  integrators: tuple[int, ...] = (_EULER,)

  def path(self, name: str) -> Path:
    return DIR / f"{name}.npz"


_JOINT_MUSCLE = """
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j" type="hinge" axis="0 1 0" range="-0.2 1.5"
             limited="true" damping="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
            contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <actuator><muscle name="m" joint="j"/></actuator>
</mujoco>"""

_TENDON_MUSCLE = """
<mujoco><option timestep="0.002"/>
  <worldbody>
    <site name="s0" pos="0 0 1.1"/>
    <body pos="0 0 1">
      <joint name="j" type="hinge" axis="0 1 0" range="-1.0 1.0"
             limited="true" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
            contype="0" conaffinity="0"/>
      <site name="s1" pos="0.3 0 0"/>
    </body>
  </worldbody>
  <tendon><spatial name="t" limited="true" range="0 0.6">
    <site site="s0"/><site site="s1"/>
  </spatial></tendon>
  <actuator><muscle name="m" tendon="t"/></actuator>
</mujoco>"""

_ACTDYN = """
<mujoco>
  <option gravity="0 0 -9.81" timestep="0.002" integrator="Euler"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1" armature="0.01"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04" density="800"
            contype="0" conaffinity="0"/>
      <body pos="0.4 0 0">
        <joint name="j2" type="hinge" axis="0 0 1" damping="0.05" armature="0.02"/>
        <geom type="capsule" fromto="0 0 0 0.3 0.1 0" size="0.03"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    {actuators}
  </actuator>
</mujoco>
"""

_ACT_SETS = {
  "integrator": """
    <general joint="j1" dyntype="integrator" gainprm="3.0" dynprm="1 0 0"/>
    <general joint="j2" gainprm="2.0"/>
  """,
  "filter": """
    <general joint="j1" dyntype="filter" gainprm="4.0" dynprm="0.05 0 0"/>
    <general joint="j2" dyntype="filter" gainprm="1.5" dynprm="0.2 0 0"
             actrange="-0.3 0.3" actlimited="true"/>
  """,
  "filterexact": """
    <general joint="j1" dyntype="filterexact" gainprm="4.0" dynprm="0.05 0 0"/>
    <general joint="j2" dyntype="filterexact" gainprm="1.5" dynprm="0.01 0 0"
             actrange="-0.5 0.5" actlimited="true"/>
  """,
  "mixed_early": """
    <general joint="j1" dyntype="filter" gainprm="4.0" dynprm="0.05 0 0"
             actearly="true"/>
    <general joint="j2" dyntype="integrator" gainprm="1.0" dynprm="1 0 0"
             actrange="-0.4 0.4" actlimited="true" actearly="true"/>
  """,
}

_ACTDYN_MUSCLE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1"><joint name="j" type="hinge" axis="0 1 0" damping="0.1"
            range="-1.2 1.2" limited="true"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04" density="900"
            contype="0" conaffinity="0"/></body>
  </worldbody>
  <actuator><muscle joint="j" timeconst="0.01 0.04"/></actuator>
</mujoco>
"""

_FLUID = """
<mujoco>
  <option gravity="0 0 -9.81" timestep="0.002" integrator="Euler"
          {fluid}/>
  <worldbody>
    <body name="torso" pos="0 0 1">
      <freejoint/>
      <geom type="capsule" fromto="0 0 -0.2 0 0 0.2" size="0.08"
            contype="0" conaffinity="0"/>
      <body pos="0.1 0 -0.2" quat="0.92 0.38 0 0">
        <joint type="hinge" axis="0 1 0" damping="0.5" armature="0.03"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.05"
              contype="0" conaffinity="0"/>
        <body pos="0 0 -0.3">
          <joint type="hinge" axis="1 0 0" damping="0.2" armature="0.01"/>
          <geom type="box" size="0.06 0.04 0.08" contype="0" conaffinity="0"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

_FLUIDS = {
  "viscosity": 'viscosity="1.5"',
  "density": 'density="900"',
  "wind": 'density="500" wind="1.2 -0.7 0.4"',
  "all": 'viscosity="0.9" density="1000" wind="-0.5 2.0 0.3"',
}

# tests/test_physics_tendon_spatial.py: a cart and a pendulum coupled by a
# three-site cable over a world site.
_CABLE = """
<mujoco>
  <option timestep="0.002" integrator="Euler"/>
  <worldbody>
    <site name="anchor" pos="0 0 1.5"/>
    <body name="cart" pos="0 0 1">
      <joint name="slide" type="slide" axis="1 0 0" damping="0.3"/>
      <geom type="box" size="0.08 0.06 0.04" mass="1.2"
            contype="0" conaffinity="0"/>
      <site name="s_cart" pos="0.05 0 0.04"/>
    </body>
    <body name="arm" pos="0.6 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" density="700"
            contype="0" conaffinity="0"/>
      <site name="s_arm" pos="0.3 0 0"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="{stiffness}" damping="{damping}"
             springlength="{springlength}" {limits}>
      <site site="s_cart"/><site site="anchor"/><site site="s_arm"/>
    </spatial>
  </tendon>
  {extra}
</mujoco>
"""

# tests/test_physics_tendon_wrap.py: a cable from a world site around a
# wrap geom on a turning body to a swinging arm.
_WRAP = """
<mujoco>
  <option timestep="0.002" integrator="Euler"/>
  <worldbody>
    <site name="s0" pos="-0.5 0 1.2"/>
    <body name="wrapbody" pos="0 0 1">
      <joint name="wj" type="hinge" axis="0 0 1"/>
      <geom name="wrapgeom" type="{gtype}" size="{size}" contype="0" conaffinity="0"/>
      <site name="side" pos="{sidepos}"/>
      <geom type="sphere" size="0.02" pos="0.3 0 0" contype="0" conaffinity="0"
            mass="0.5"/>
    </body>
    <body name="arm" pos="0.6 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" density="700"
            contype="0" conaffinity="0"/>
      <site name="s1" pos="0.3 0 0"/>
    </body>
  </worldbody>
  <tendon><spatial name="cable" stiffness="{stiffness}" damping="{damping}"
      springlength="0">
    <site site="s0"/><geom geom="wrapgeom" {side}/><site site="s1"/>
  </spatial></tendon>
  {extra}
</mujoco>
"""

_WRAP_CASES = {
  "sphere": dict(gtype="sphere", size="0.15", sidepos="0 0.4 0", side=""),
  "cylinder": dict(gtype="cylinder", size="0.15 0.3", sidepos="0 0.4 0.1", side=""),
  "sphere_side_pos": dict(gtype="sphere", size="0.15", sidepos="0 0.4 0",
                          side='sidesite="side"'),
  "sphere_side_neg": dict(gtype="sphere", size="0.15", sidepos="0 -0.4 0",
                          side='sidesite="side"'),
  "cylinder_side": dict(gtype="cylinder", size="0.15 0.3", sidepos="0 -0.4 -0.1",
                        side='sidesite="side"'),
}

_PULLEY = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a0" pos="0 0 1.5"/>
    <site name="a1" pos="0.4 0 1.5"/>
    <body pos="0 0 1">
      <joint name="h" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" density="700"
            contype="0" conaffinity="0"/>
      <site name="b0" pos="0.1 0 0"/>
      <site name="b1" pos="0.3 0 0"/>
    </body>
  </worldbody>
  <tendon><spatial name="t" stiffness="30" springlength="0.8">
    <pulley divisor="2"/><site site="a0"/><site site="b0"/>
    <pulley divisor="2"/><site site="a1"/><site site="b1"/>
  </spatial></tendon>
</mujoco>"""

# tests/test_physics_contacts.py: pyramidal contacts, a joint limit and dof
# friction loss (every dual projection) under PGS.
_PGS_RIG = """
<mujoco><option timestep="0.002" solver="PGS" iterations="100"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1"/>
    <body pos="0 0 0.1" euler="2 1 0"><freejoint/>
      <geom type="box" size="0.1 0.08 0.06" friction="0.7 0.01 0.001"/>
      <body pos="0.1 0 0.1">
        <joint name="arm" type="hinge" axis="0 1 0" range="-0.5 0.5"
               frictionloss="0.2" damping="0.01"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody></mujoco>"""

# The equality scene of the PGS tests: a connect and a joint equality (both
# unbounded dual rows) beside a joint limit, no contacts.
_PGS_EQUALITY = """
<mujoco><option timestep="0.002" solver="PGS" iterations="60"/>
  <worldbody>
    <body name="a" pos="0 0 1"><joint name="ja" type="hinge" axis="0 1 0"
        range="-0.6 0.6" limited="true"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03" density="800"
            contype="0" conaffinity="0"/></body>
    <body name="b" pos="0.8 0 1"><joint name="jb" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 -0.4 0 0" size="0.03" density="800"
            contype="0" conaffinity="0"/>
      <body pos="-0.4 0 0"><joint name="jc" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02" density="800"
              contype="0" conaffinity="0"/></body></body>
  </worldbody>
  <equality><connect body1="a" body2="b" anchor="0.4 0 0"/>
    <joint joint1="jc" joint2="ja" polycoef="0 0.5 0 0 0"/></equality>
</mujoco>"""

_MUSCLE_ARM = """
<mujoco model="muscle_arm">
  <compiler angle="radian"/>
  <option timestep="0.002" integrator="implicitfast" density="1.2" viscosity="0.00002"
          wind="0.6 0 -0.2"/>
  <default>
    <geom contype="0" conaffinity="0" density="1000"/>
    <joint damping="0.05" armature="0.005" limited="true"/>
  </default>
  <worldbody>
    <site name="fl_origin" pos="-0.1 0 0.1"/>
    <site name="ex_origin" pos="-0.1 0 -0.1"/>
    <site name="fl_side" pos="0 0 0.2"/>
    <site name="ex_side" pos="0 0 -0.2"/>
    <site name="pulley_origin" pos="-0.15 0 0.05"/>
    <geom name="shoulder_wrap" type="cylinder" size="0.04 0.05" euler="1.5707963 0 0"/>
    <body name="upper" pos="0 0 0">
      <joint name="shoulder" type="hinge" axis="0 1 0" range="-1.5 1.5"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.035"/>
      <site name="fl_insert" pos="0.12 0 0.035"/>
      <site name="ex_insert" pos="0.12 0 -0.035"/>
      <site name="bi_origin" pos="0.08 0 0.04"/>
      <site name="tri_origin" pos="0.08 0 -0.04"/>
      <site name="pulley_mid" pos="0.15 0 0.04"/>
      <site name="pulley_mid2" pos="0.2 0 0.04"/>
      <geom name="elbow_wrap" type="sphere" size="0.03" pos="0.3 0 0"/>
      <body name="fore" pos="0.3 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-0.2 2.2"/>
        <geom type="capsule" fromto="0 0 0 0.25 0 0" size="0.03"/>
        <site name="bi_insert" pos="0.06 0 0.03"/>
        <site name="tri_insert" pos="-0.03 0 -0.02"/>
        <site name="pulley_insert" pos="0.1 0 0.03"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="flexor_t"><site site="fl_origin"/>
      <geom geom="shoulder_wrap" sidesite="fl_side"/><site site="fl_insert"/></spatial>
    <spatial name="extensor_t"><site site="ex_origin"/>
      <geom geom="shoulder_wrap" sidesite="ex_side"/><site site="ex_insert"/></spatial>
    <spatial name="biceps_t"><site site="bi_origin"/>
      <geom geom="elbow_wrap"/><site site="bi_insert"/></spatial>
    <spatial name="triceps_t"><site site="tri_origin"/>
      <geom geom="elbow_wrap"/><site site="tri_insert"/></spatial>
    <spatial name="pulley_t">
      <pulley divisor="2"/><site site="pulley_origin"/><site site="pulley_mid"/>
      <pulley divisor="2"/><site site="pulley_mid2"/><site site="pulley_insert"/>
    </spatial>
  </tendon>
  <actuator>
    <muscle name="flexor" tendon="flexor_t" force="40" lengthrange="0.07 0.30"/>
    <muscle name="extensor" tendon="extensor_t" force="40" lengthrange="0.07 0.30"/>
    <muscle name="biceps" tendon="biceps_t" force="25" lengthrange="0.23 0.30"/>
    <muscle name="triceps" tendon="triceps_t" force="25" lengthrange="0.18 0.24"/>
    <muscle name="two_joint" tendon="pulley_t" force="15" lengthrange="0.15 0.27"/>
    <general name="elbow_filter" joint="elbow" dyntype="filterexact" dynprm="0.03"
             gainprm="0.8" actlimited="true" actrange="-0.5 0.5"/>
    <intvelocity name="shoulder_int" joint="shoulder" kp="3" actrange="-1 1"/>
  </actuator>
  <sensor>
    <actuatorpos actuator="biceps"/>
    <actuatorvel actuator="biceps"/>
    <actuatorfrc actuator="flexor"/>
    <tendonpos tendon="pulley_t"/>
  </sensor>
</mujoco>"""


def _cable(extra: str = "", stiffness=60.0, damping=2.5, springlength="1.2",
           limits='limited="true" range="0.5 1.45"') -> str:
  """The cable rig; its limit at 1.45 m, not the JAX test's 2.1 m, which
  neither engine's cable reaches: from the scene's state the limit row is
  active for its first 8 substeps."""
  return _CABLE.format(stiffness=stiffness, damping=damping, springlength=springlength,
                       limits=limits, extra=extra)


SCENES: dict[str, MuscleScene] = {
  "joint_muscle": MuscleScene(_JOINT_MUSCLE, ctrl=_phases(0.9, 0.2, 1.0),
                              integrators=(_EULER, _IMPLICITFAST)),
  "tendon_muscle": MuscleScene(_TENDON_MUSCLE, ctrl=_phases(0.8, 0.0, 0.5)),
  **{f"actdyn_{k}": MuscleScene(_ACTDYN.format(actuators=v), _actdyn_state, _sines,
                                (_EULER, _IMPLICITFAST, _RK4))
     for k, v in _ACT_SETS.items()},
  "actdyn_muscle": MuscleScene(
    _ACTDYN_MUSCLE, ctrl=lambda k, nu: np.full(nu, 0.5 + 0.5 * np.sin(0.1 * k))),
  **{f"fluid_{k}": MuscleScene(_FLUID.format(fluid=v), _fluid_state,
                               integrators=(_EULER, _IMPLICITFAST))
     for k, v in _FLUIDS.items()},
  "spatial_cable": MuscleScene(
    _cable('<actuator><motor tendon="cable" gear="3"/></actuator>'
           '<sensor><tendonpos tendon="cable"/><tendonvel tendon="cable"/></sensor>'),
    _velocity(1.5, -2.0), lambda k, nu: np.full(nu, np.sin(0.05 * k)),
    (_EULER, _IMPLICITFAST)),
  "spatial_equality": MuscleScene(
    _cable('<tendon><fixed name="joints"><joint joint="slide" coef="1.0"/></fixed></tendon>'
           '<equality><tendon tendon1="cable" tendon2="joints" polycoef="0.0 0.5 0 0 0"/>'
           '</equality>', stiffness=0.0, damping=0.2, springlength="0", limits=""),
    _velocity(0.6, -0.8)),
  **{f"wrap_{k}": MuscleScene(_WRAP.format(stiffness=40.0, damping=1.0, extra="", **v),
                              _velocity(1.0, -1.5), integrators=(_EULER, _IMPLICITFAST))
     for k, v in _WRAP_CASES.items()},
  "wrap_motor": MuscleScene(
    _WRAP.format(stiffness=0.0, damping=0.3,
                 extra='<actuator><motor tendon="cable" gear="2"/></actuator>',
                 **_WRAP_CASES["sphere"]),
    ctrl=lambda k, nu: np.full(nu, np.cos(0.04 * k))),
  "pulley": MuscleScene(_PULLEY, _velocity(0.8)),
  "pgs_rig": MuscleScene(_PGS_RIG, _pgs_state),
  "pgs_equality": MuscleScene(_PGS_EQUALITY, _velocity(0.8, -0.5, 1.2)),
  "muscle_arm": MuscleScene(_MUSCLE_ARM, _velocity(0.5, -0.8), _arm_ctrl,
                            (_IMPLICITFAST, _EULER, _RK4)),
}


def load(name: str, integrator: int | None = None):
  """The scene's committed model (`load_model_npz`), under `integrator` if
  given."""
  from mjlab_tpu_torch.assets import load_model_npz

  m = load_model_npz(SCENES[name].path(name))
  if integrator is not None:
    m.opt.integrator = integrator
  return m


# ---------------------------------------------------------------------------
# The filter-actuated hopper env (tests/test_physics_actdyn.py).
# ---------------------------------------------------------------------------

HOPPER_FILTER_XML = """
<mujoco model="hopper">
  <worldbody>
    <body name="base" pos="0 0 0.6">
      <freejoint/>
      <geom name="base_collision" type="sphere" size="0.12" density="800"/>
      <body name="leg" pos="0 0 -0.12">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1.2 1.2"/>
        <geom name="leg_collision" type="capsule" fromto="0 0 0 0 0 -0.35" size="0.04"/>
        <body name="foot" pos="0 0 -0.35">
          <joint name="knee" type="hinge" axis="0 1 0" range="-1.5 1.5"/>
          <geom name="foot_collision" type="capsule" fromto="0 0 0 0.12 0 0" size="0.035"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <general name="hip" joint="hip" dyntype="filter" dynprm="0.05 0 0"
             gainprm="40" biasprm="0 -40 -2"/>
    <general name="knee" joint="knee" dyntype="filter" dynprm="0.05 0 0"
             gainprm="40" biasprm="0 -40 -2"/>
  </actuator>
</mujoco>
"""


def hopper_filter_env_cfg(num_envs: int = 2, dtype: str = "float64"):
  """The port's cfg of the JAX test's filter-actuated hopper env: the scene
  is the committed HOPPER_FILTER compile (robot at 0.6 m, hip 0.2 and knee
  -0.4), a joint-position action of scale 0.5 about the defaults, an alive
  reward and a 0.2 s time-out (10 env steps of 4 substeps of 5 ms)."""
  from mjlab_tpu_torch.entity import EntityArticulationInfoCfg, EntityCfg
  from mjlab_tpu_torch.envs import ManagerBasedRlEnvCfg, mdp
  from mjlab_tpu_torch.envs.mdp.actions import JointPositionActionCfg
  from mjlab_tpu_torch.managers import (
    ObservationGroupCfg,
    ObservationTermCfg,
    RewardTermCfg,
    TerminationTermCfg,
  )
  from mjlab_tpu_torch.scene import SceneCfg
  from mjlab_tpu_torch.sim import MujocoCfg, SimulationCfg
  from mjlab_tpu_torch.terrains import TerrainImporterCfg

  robot = EntityCfg(
    init_state=EntityCfg.InitialStateCfg(pos=(0, 0, 0.6), joint_pos={"hip": 0.2, "knee": -0.4}),
    articulation=EntityArticulationInfoCfg(actuators=()),
  )
  return ManagerBasedRlEnvCfg(
    decimation=4,
    episode_length_s=0.2,
    scene=SceneCfg(num_envs=num_envs, terrain=TerrainImporterCfg(terrain_type="plane"),
                   entities={"robot": robot}, model_file=HOPPER_FILTER),
    observations={"policy": ObservationGroupCfg(
      terms={"joint_pos": ObservationTermCfg(func=mdp.joint_pos_rel)})},
    actions={"joint_pos": JointPositionActionCfg(
      asset_name="robot", actuator_names=(".*",), scale=0.5, use_default_offset=True)},
    rewards={"alive": RewardTermCfg(func=mdp.is_alive, weight=1.0)},
    terminations={"time_out": TerminationTermCfg(func=mdp.time_out, time_out=True)},
    sim=SimulationCfg(dtype=dtype, mujoco=MujocoCfg(timestep=0.005, iterations=5,
                                                    ls_iterations=10)),
    seed=0,
  )
