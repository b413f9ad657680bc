"""Small scenes of a user's own robot: ball joints and their cone limits,
bodies with several joints, the sensor catalog (frame sensors also in a
reference frame), explicit `<pair>`s, a mocap body and gravity compensation
(the JAX package's physics and sensor test scenes, a gimbal and a small
humanoid).

Each scene's MJCF is kept here and its compile is committed as
`surface/<name>.npz` (`assets.save_model_npz`), so that a host without
`mujoco` can load it (`load(name)`); `tests/test_torch_surface_scenes.py`
checks that each file is fresh and says how to regenerate them. A scene's
`qpos`, `qvel`, `ctrl` and `time` are the state its JAX test sets (qpos
None: the model's qpos0), `mocap_pos` the target a mocap body is moved to,
and `cones` the cones it runs under.

The humanoid has multi-hinge bodies (abdomen, shoulders, ankles), one ball
hip per leg with a 50° cone limit, capsule and sphere contacts against the
floor (Newton rows), motors on its hinges, and the sensor types the JAX
test scenes leave out (joint, actuator and subtree sensors) beside frame
sensors in five reference frames.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from mjlab_tpu_torch.physics.types import mjtCone

DIR = Path(__file__).parent / "surface"


@dataclasses.dataclass(frozen=True)
class SurfaceScene:
  xml: str
  qvel: tuple[float, ...] = ()
  qpos: tuple[float, ...] | None = None
  ctrl: tuple[float, ...] = ()
  time: float = 0.0
  mocap_pos: tuple[float, float, float] | None = None
  cones: tuple[int, ...] = (mjtCone.mjCONE_PYRAMIDAL,)

  def path(self, name: str) -> Path:
    return DIR / f"{name}.npz"


_BOTH_CONES = (mjtCone.mjCONE_PYRAMIDAL, mjtCone.mjCONE_ELLIPTIC)

HUMANOID_XML = """
<mujoco model="small_humanoid">
  <option timestep="0.004"/>
  <default>
    <joint damping="0.5" armature="0.02" limited="true"/>
    <geom contype="1" conaffinity="0" condim="3" friction="0.9 0.005 0.0001" density="800"/>
    <motor ctrlrange="-1 1" ctrllimited="true"/>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" contype="1" conaffinity="1"/>
    <body name="torso" pos="0 0 1.218">
      <freejoint name="root"/>
      <geom name="torso" type="capsule" fromto="0 -0.07 0 0 0.07 0" size="0.07"/>
      <geom name="head" type="sphere" pos="0 0 0.19" size="0.09"/>
      <site name="imu" pos="0 0 0.05"/>
      <site name="eye" pos="0.1 0 0.19" zaxis="1 0 -1"/>
      <body name="arm_right" pos="0 -0.17 0.06">
        <joint name="shoulder1_right" type="hinge" axis="2 1 1" range="-85 60"/>
        <joint name="shoulder2_right" type="hinge" axis="0 -1 1" range="-85 60"/>
        <geom name="upper_arm_right" type="capsule" fromto="0 0 0 0.16 -0.16 -0.16" size="0.04"/>
        <body name="forearm_right" pos="0.18 -0.18 -0.18">
          <joint name="elbow_right" type="hinge" axis="0 -1 1" range="-90 50"/>
          <geom name="forearm_right" type="capsule" fromto="0.01 0.01 0.01 0.17 0.17 0.17" size="0.031"/>
          <geom name="hand_right" type="sphere" pos="0.18 0.18 0.18" size="0.04"/>
        </body>
      </body>
      <body name="arm_left" pos="0 0.17 0.06">
        <joint name="shoulder1_left" type="hinge" axis="-2 1 -1" range="-60 85"/>
        <joint name="shoulder2_left" type="hinge" axis="0 -1 -1" range="-60 85"/>
        <geom name="upper_arm_left" type="capsule" fromto="0 0 0 0.16 0.16 -0.16" size="0.04"/>
        <body name="forearm_left" pos="0.18 0.18 -0.18">
          <joint name="elbow_left" type="hinge" axis="0 -1 -1" range="-90 50"/>
          <geom name="forearm_left" type="capsule" fromto="0.01 -0.01 0.01 0.17 -0.17 0.17" size="0.031"/>
          <geom name="hand_left" type="sphere" pos="0.18 -0.18 0.18" size="0.04"/>
        </body>
      </body>
      <body name="waist" pos="-0.01 0 -0.26">
        <joint name="abdomen_z" type="hinge" axis="0 0 1" range="-45 45"/>
        <joint name="abdomen_y" type="hinge" axis="0 1 0" range="-75 30"/>
        <joint name="abdomen_x" type="hinge" axis="1 0 0" range="-35 35" pos="0 0 -0.06"/>
        <geom name="waist" type="capsule" fromto="0 -0.06 0 0 0.06 0" size="0.06"/>
        <geom name="pelvis" type="capsule" fromto="-0.02 -0.07 -0.1 -0.02 0.07 -0.1" size="0.09"/>
        <body name="thigh_right" pos="0 -0.1 -0.14">
          <joint name="hip_right" type="ball" range="0 50"/>
          <geom name="thigh_right" type="capsule" fromto="0 0 0 0 0.01 -0.34" size="0.06"/>
          <body name="shin_right" pos="0 0.01 -0.403">
            <joint name="knee_right" type="hinge" axis="0 -1 0" range="-150 3"/>
            <geom name="shin_right" type="capsule" fromto="0 0 0 0 0 -0.3" size="0.049"/>
            <site name="shin_ft_right" pos="0 0 -0.15"/>
            <body name="foot_right" pos="0 0 -0.39">
              <joint name="ankle_y_right" type="hinge" axis="0 1 0" range="-50 50" pos="0 0 0.08"/>
              <joint name="ankle_x_right" type="hinge" axis="1 0 0.5" range="-50 50" pos="0 0 0.04"/>
              <geom name="foot_right" type="capsule" fromto="-0.07 -0.02 0 0.14 -0.04 0" size="0.027"/>
              <geom name="toe_right" type="sphere" pos="0.14 -0.04 0" size="0.027"/>
              <site name="sole_right" type="box" pos="0.035 -0.03 0" size="0.12 0.05 0.04"/>
            </body>
          </body>
        </body>
        <body name="thigh_left" pos="0 0.1 -0.14">
          <joint name="hip_left" type="ball" range="0 50"/>
          <geom name="thigh_left" type="capsule" fromto="0 0 0 0 -0.01 -0.34" size="0.06"/>
          <body name="shin_left" pos="0 -0.01 -0.403">
            <joint name="knee_left" type="hinge" axis="0 -1 0" range="-150 3"/>
            <geom name="shin_left" type="capsule" fromto="0 0 0 0 0 -0.3" size="0.049"/>
            <body name="foot_left" pos="0 0 -0.39">
              <joint name="ankle_y_left" type="hinge" axis="0 1 0" range="-50 50" pos="0 0 0.08"/>
              <joint name="ankle_x_left" type="hinge" axis="1 0 0.5" range="-50 50" pos="0 0 0.04"/>
              <geom name="foot_left" type="capsule" fromto="-0.07 0.02 0 0.14 0.04 0" size="0.027"/>
              <geom name="toe_left" type="sphere" pos="0.14 0.04 0" size="0.027"/>
            </body>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="abdomen_z" joint="abdomen_z" gear="40"/>
    <motor name="abdomen_y" joint="abdomen_y" gear="40"/>
    <motor name="abdomen_x" joint="abdomen_x" gear="40"/>
    <motor name="knee_right" joint="knee_right" gear="80"/>
    <motor name="ankle_y_right" joint="ankle_y_right" gear="20"/>
    <motor name="ankle_x_right" joint="ankle_x_right" gear="10"/>
    <motor name="knee_left" joint="knee_left" gear="80"/>
    <motor name="ankle_y_left" joint="ankle_y_left" gear="20"/>
    <motor name="ankle_x_left" joint="ankle_x_left" gear="10"/>
    <motor name="shoulder1_right" joint="shoulder1_right" gear="25"/>
    <motor name="shoulder2_right" joint="shoulder2_right" gear="25"/>
    <motor name="elbow_right" joint="elbow_right" gear="25"/>
    <motor name="shoulder1_left" joint="shoulder1_left" gear="25"/>
    <motor name="shoulder2_left" joint="shoulder2_left" gear="25"/>
    <motor name="elbow_left" joint="elbow_left" gear="25"/>
  </actuator>
  <sensor>
    <jointpos name="knee_pos" joint="knee_right"/>
    <jointvel name="knee_vel" joint="knee_right"/>
    <actuatorpos name="knee_act_pos" actuator="knee_right"/>
    <actuatorvel name="knee_act_vel" actuator="knee_right"/>
    <actuatorfrc name="knee_act_frc" actuator="knee_right"/>
    <jointactuatorfrc name="knee_jnt_frc" joint="knee_right"/>
    <subtreecom name="torso_com" body="torso"/>
    <subtreelinvel name="torso_linvel" body="torso"/>
    <subtreeangmom name="torso_angmom" body="torso"/>
    <jointlimitpos name="hip_limit_pos" joint="hip_right"/>
    <jointlimitvel name="hip_limit_vel" joint="hip_right"/>
    <jointlimitfrc name="hip_limit_frc" joint="hip_right"/>
    <gyro name="gyro" site="imu"/>
    <accelerometer name="accel" site="imu"/>
    <touch name="sole_touch" site="sole_right"/>
    <force name="shin_force" site="shin_ft_right"/>
    <torque name="shin_torque" site="shin_ft_right"/>
    <rangefinder name="eye_range" site="eye"/>
    <e_kinetic name="ekin"/>
    <e_potential name="epot"/>
    <framepos name="sole_in_imu" objtype="site" objname="sole_right" reftype="site" refname="imu"/>
    <framequat name="foot_in_torso" objtype="body" objname="foot_right" reftype="xbody" refname="torso"/>
    <framexaxis name="shin_x_in_thigh" objtype="geom" objname="shin_right" reftype="body" refname="thigh_right"/>
    <framezaxis name="hand_z_in_waist" objtype="xbody" objname="forearm_left" reftype="geom" refname="waist"/>
    <framelinvel name="sole_vel_in_imu" objtype="site" objname="sole_right" reftype="site" refname="imu"/>
    <frameangvel name="foot_angvel_in_torso" objtype="xbody" objname="foot_right" reftype="body" refname="torso"/>
    <framelinvel name="hand_vel_in_waist" objtype="body" objname="forearm_right" reftype="xbody" refname="waist"/>
  </sensor>
</mujoco>
"""

SCENES: dict[str, SurfaceScene] = {
  # tests/test_physics_ball_limit.py: a ball and a hinge in a chain.
  "ball_limit": SurfaceScene("""
<mujoco><option timestep="0.002" jacobian="dense"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="b" type="ball" range="0 40" damping="0.02"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" density="800"
            contype="0" conaffinity="0"/>
      <body pos="0.3 0 0">
        <joint name="h" type="hinge" axis="0 1 0" range="-50 50"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.025" density="800"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>""", qvel=(2.0, -1.5, 1.0, 3.0)),
  # A gimbal: three hinges on one body (offset anchors, one limited), and
  # a child with a slide and a hinge.
  "gimbal": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body name="gimbal" pos="0 0 1">
      <joint name="yaw" type="hinge" axis="0 0 1" damping="0.01"/>
      <joint name="pitch" type="hinge" axis="0 1 0" pos="0.02 0 0" damping="0.01"/>
      <joint name="roll" type="hinge" axis="1 0 0" pos="0 0.01 0" range="-60 60"
             limited="true" damping="0.01"/>
      <geom type="box" size="0.2 0.05 0.02" pos="0.1 0.03 0" density="500"
            contype="0" conaffinity="0"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02" contype="0" conaffinity="0"/>
      <body name="pendulum" pos="0.3 0 0">
        <joint name="slide" type="slide" axis="1 0 0" range="-0.1 0.1" limited="true"/>
        <joint name="swing" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.25" size="0.02" density="800"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>""", qvel=(1.5, -2.0, 3.0, 0.5, -1.0)),
  "humanoid": SurfaceScene(HUMANOID_XML),
  # tests/test_sensors_extended.py: tendon, joint-limit, magnetometer,
  # clock, energy and frame-acceleration sensors.
  "sensor_rig": SurfaceScene("""
<mujoco model="sensor_rig">
  <option timestep="0.002" magnetic="0.2 -0.4 0.5"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1"/>
    <body name="base" pos="0 0 0.6">
      <freejoint/>
      <geom name="torso" type="box" size="0.1 0.08 0.05" density="600"/>
      <site name="imu" pos="0.02 0 0.03"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="shoulder" type="hinge" axis="0 1 0" range="-0.8 0.8"
               stiffness="4.0" springref="0.1" margin="0.05"/>
        <geom name="arm_geom" type="capsule" fromto="0 0 0 0.25 0 0" size="0.03"/>
        <body name="hand" pos="0.25 0 0">
          <joint name="wrist" type="hinge" axis="0 1 0" range="-1.0 1.0"/>
          <geom name="hand_geom" type="sphere" size="0.04"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="couple">
      <joint joint="shoulder" coef="0.7"/>
      <joint joint="wrist" coef="-0.4"/>
    </fixed>
  </tendon>
  <actuator>
    <position name="shoulder_act" joint="shoulder" kp="12" ctrlrange="-0.8 0.8"/>
  </actuator>
  <sensor>
    <magnetometer name="mag" site="imu"/>
    <clock name="clk"/>
    <tendonpos name="tpos" tendon="couple"/>
    <tendonvel name="tvel" tendon="couple"/>
    <jointlimitpos name="jlp" joint="shoulder"/>
    <jointlimitvel name="jlv" joint="shoulder"/>
    <jointlimitfrc name="jlf" joint="shoulder"/>
    <jointactuatorfrc name="jaf" joint="shoulder"/>
    <framelinacc name="linacc" objtype="site" objname="imu"/>
    <frameangacc name="angacc" objtype="site" objname="imu"/>
    <e_potential name="epot"/>
    <e_kinetic name="ekin"/>
  </sensor>
</mujoco>""", qpos=(0.05, -0.02, 0.9, 0.98, 0.1, 0.15, 0.05, 0.78, -0.3),
    qvel=(0.3, -0.2, 0.1, 0.4, -0.5, 0.2, 1.5, -0.8), ctrl=(0.6,), time=1.25),
  # tests/test_sensors_ft.py: force, torque, touch, rangefinder and
  # tendon actuator force, and the explicit floor-box pair.
  "ft_rig": SurfaceScene("""
<mujoco model="ft_rig">
  <option timestep="0.002" cone="pyramidal"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1"/>
    <body name="base" pos="0 0 0.0995">
      <freejoint/>
      <geom name="box" type="box" size="0.1 0.1 0.1" density="500"/>
      <site name="touch_site" type="box" size="0.12 0.12 0.12"/>
      <site name="rf_down" pos="0.3 0 0" zaxis="0 0 -1"/>
      <site name="rf_up" pos="0.3 0 0" zaxis="0 0 1"/>
      <site name="rf_away" pos="0 0.3 0" zaxis="0 1 0"/>
      <body name="arm" pos="0 0 0.15">
        <joint name="shoulder" type="hinge" axis="0 1 0"/>
        <geom name="arm_geom" type="capsule" fromto="0 0 0 0.3 0 0"
              size="0.03" density="800"/>
        <site name="ft_arm" pos="0.05 0 0"/>
        <body name="hand" pos="0.3 0 0">
          <joint name="wrist" type="hinge" axis="0 1 0"/>
          <geom name="hand_geom" type="sphere" size="0.04" density="700"/>
        </body>
      </body>
    </body>
    <body name="ball" pos="0.3 0 0.6">
      <freejoint/>
      <geom name="ball_geom" type="sphere" size="0.07" density="300"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="box"/>
  </contact>
  <tendon>
    <fixed name="couple">
      <joint joint="shoulder" coef="0.7"/>
      <joint joint="wrist" coef="-0.4"/>
    </fixed>
  </tendon>
  <actuator>
    <motor name="ten_act" tendon="couple" gear="1.5" ctrlrange="-5 5"/>
  </actuator>
  <sensor>
    <force name="f_arm" site="ft_arm"/>
    <torque name="t_arm" site="ft_arm"/>
    <touch name="touch" site="touch_site"/>
    <rangefinder name="rf_hit" site="rf_down"/>
    <rangefinder name="rf_ball" site="rf_up"/>
    <rangefinder name="rf_miss" site="rf_away"/>
    <tendonactuatorfrc name="taf" tendon="couple"/>
  </sensor>
</mujoco>""", qpos=(0.0, 0.0, 0.0995, 1.0, 0.0, 0.0, 0.0, 0.4, -0.2,
                   0.3, 0.0, 0.6, 1.0, 0.0, 0.0, 0.0),
    qvel=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.8, -0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    ctrl=(2.0,)),
  # tests/test_physics_mocap.py: a ball welded to a mocap target.
  "mocap_weld": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="target" mocap="true" pos="0.5 0 0.6">
      <geom type="box" size="0.05 0.05 0.05" contype="0" conaffinity="0"/>
    </body>
    <body name="ball" pos="0 0 0.5"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
  <equality><weld body1="target" body2="ball" torquescale="0.5"/></equality>
</mujoco>""", mocap_pos=(0.6, 0.05, 0.6)),
  # mocap_weld with its bodies named as a scene names its entities'
  # ("<entity>/<body>"), so that the mocap target is an entity of its own
  # (the mocap reset of envs.mdp.reset_root_state_uniform).
  "mocap_entity": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="target/base" mocap="true" pos="0.5 0 0.6">
      <geom type="box" size="0.05 0.05 0.05" contype="0" conaffinity="0"/>
    </body>
    <body name="ball/base" pos="0 0 0.5"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
  <equality><weld body1="target/base" body2="ball/base" torquescale="0.5"/></equality>
</mujoco>""", mocap_pos=(0.6, 0.05, 0.6)),
  # tests/test_physics_gravcomp.py: a two-link arm, fully and half
  # compensated.
  "gravcomp_arm": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1" gravcomp="1.0">
      <joint name="a" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.03" density="900"
            contype="0" conaffinity="0"/>
      <body pos="0.4 0 0" gravcomp="0.5">
        <joint name="b" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.025" density="900"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>""", qvel=(0.7, -1.1)),
  # tests/test_physics_contacts.py: the pair scenes.
  "pair_only": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" contype="0"
          conaffinity="0" friction="0.3" solref="0.05 0.8"/>
    <body pos="0.01 0.02 0.093"><freejoint/>
      <geom name="ball" type="sphere" size="0.1" contype="0" conaffinity="0"
            friction="0.3 0.001 0.0001"/></body>
  </worldbody>
  <contact>
    <pair geom1="floor" geom2="ball"
          friction="1.3 1.1 0.007 0.0003 0.0002"
          solref="0.01 1.2" solimp="0.85 0.97 0.002 0.4 2"
          margin="0.002" gap="0.0005" condim="6"/>
  </contact>
</mujoco>""", qvel=(0.4, -0.2, -0.3, 0.5, 0.2, -0.1)),
  "pair_precedence": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" friction="0.8"/>
    <body pos="0 0 0.095"><freejoint/>
      <geom name="ball" type="sphere" size="0.1" friction="0.8"/></body>
  </worldbody>
  <contact><pair geom1="floor" geom2="ball" condim="1"
                 friction="0 0 0 0 0"/></contact>
</mujoco>""", qvel=(1.0,)),
  "pair_solreffriction": SurfaceScene("""
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" contype="0"
          conaffinity="0"/>
    <body pos="0 0 0.095"><freejoint/>
      <geom name="ball" type="sphere" size="0.1" contype="0"
            conaffinity="0"/></body>
  </worldbody>
  <contact><pair geom1="floor" geom2="ball" condim="3"
                 friction="0.8 0.8 0.005 0 0" solref="0.02 1"
                 solreffriction="0.05 0.4"/></contact>
</mujoco>""", qvel=(0.6,), cones=_BOTH_CONES),
}


def load(name: str, cone: int | None = None):
  """The scene's committed model (`load_model_npz`), under `cone` if
  given."""
  from mjlab_tpu_torch.assets import load_model_npz

  m = load_model_npz(SCENES[name].path(name))
  if cone is not None:
    m.opt.cone = cone
  return m
