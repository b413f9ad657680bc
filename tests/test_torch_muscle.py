"""The port's muscle model (mjlab_tpu_torch/physics/muscle.py) against the
JAX package's (mjlab_tpu/physics/muscle.py), and the muscle scenes of
mjlab_tpu_torch/assets/muscle_scenes.py stepped in both packages, float64
on the CPU.

Under implicitfast the port takes MuJoCo's actuator velocity derivative
(mjd_actuator_vel: affine bias, and a muscle gain's force-velocity slope),
where the JAX package adds every actuator's −biasprm[2]: there the port is
held to `mujoco.mj_step`, and the JAX package is shown to miss it (ROADMAP
Queue C)."""

from __future__ import annotations

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import muscle as jmuscle
from mjlab_tpu_torch.physics import muscle as tmuscle
from mjlab_tpu_torch.physics.types import mjtIntegrator
from tests.torch_parity import assert_close, muscle_rollout, torch_threads

_N = 2000


def _grid():
  """The JAX package's muscle test grid (tests/test_physics_muscle.py)."""
  rng = np.random.default_rng(0)
  lr = np.sort(rng.uniform(0.1, 1.0, (_N, 2)), axis=1)
  prm = np.stack([
    rng.uniform(0.4, 0.9, _N), rng.uniform(1.0, 1.3, _N),
    np.where(rng.random(_N) < 0.5, -1.0, rng.uniform(10, 500, _N)),
    rng.uniform(50, 400, _N), rng.uniform(0.2, 0.9, _N), rng.uniform(1.05, 2.0, _N),
    rng.uniform(0.5, 5.0, _N), rng.uniform(0.5, 2.0, _N), rng.uniform(1.05, 2.0, _N),
  ], axis=1)
  dynprm = np.stack([
    rng.uniform(0.005, 0.05, _N), rng.uniform(0.01, 0.1, _N),
    np.where(rng.random(_N) < 0.5, 0.0, rng.uniform(0.01, 0.5, _N)),
  ], axis=1)
  return dict(
    length=rng.uniform(0.0, 1.2, _N), velocity=rng.uniform(-3, 3, _N), lengthrange=lr,
    acc0=rng.uniform(10, 300, _N), prm=prm, dynprm=dynprm,
    ctrl=rng.uniform(-0.3, 1.3, _N), act=rng.uniform(-0.3, 1.3, _N),
  )


_PRIMITIVES = {
  "gain": ("muscle_gain", ("length", "velocity", "lengthrange", "acc0", "prm")),
  "bias": ("muscle_bias", ("length", "lengthrange", "acc0", "prm")),
  "dynamics": ("muscle_dynamics", ("ctrl", "act", "dynprm")),
}


@pytest.mark.parametrize("what", sorted(_PRIMITIVES))
def test_primitives_equal_jax(what):
  """Each primitive on the JAX test's 2000-point grid (both force signs,
  both smoothing modes), within 1e-12."""
  g = _grid()
  fn, args = _PRIMITIVES[what]
  want = np.asarray(getattr(jmuscle, fn)(*[jnp.asarray(g[a]) for a in args]))
  got = getattr(tmuscle, fn)(*[torch.tensor(g[a]) for a in args]).numpy()
  assert_close(got, want, 1e-12, what)


def test_gain_velocity_slope_is_the_gains_derivative():
  """muscle_gain_vel against a central difference of muscle_gain on the
  grid, away from the force-velocity curve's kinks."""
  g = _grid()
  args = [torch.tensor(g[a]) for a in ("length", "velocity", "lengthrange", "acc0", "prm")]
  eps = 1e-6
  hi = tmuscle.muscle_gain(args[0], args[1] + eps, *args[2:])
  lo = tmuscle.muscle_gain(args[0], args[1] - eps, *args[2:])
  fd = ((hi - lo) / (2 * eps)).numpy()
  got = tmuscle.muscle_gain_vel(*args).numpy()
  # Skip points within eps of a kink, where the difference straddles it.
  L0 = (g["lengthrange"][:, 1] - g["lengthrange"][:, 0]) / (g["prm"][:, 1] - g["prm"][:, 0])
  V = g["velocity"] / (L0 * g["prm"][:, 6])
  smooth = np.min(np.abs(V[:, None] - np.stack([-np.ones(_N), np.zeros(_N), g["prm"][:, 8] - 1], 1)),
                  axis=1) > 1e-3
  assert smooth.sum() > 1900
  assert_close(got[smooth], fd[smooth], 1e-6, "gain velocity slope")


@pytest.mark.parametrize("name", ["joint_muscle", "tendon_muscle"])
def test_trajectory_equals_jax(name):
  """The JAX test's muscle scenes under Euler (activation dynamics, FLV
  gain, passive bias; the tendon muscle on a spatial tendon with a limit),
  30 substeps through three control levels: qpos, qvel and act within
  1e-10 at every step."""
  with torch_threads(1):
    run = muscle_rollout(name, 30, budget=True, record=("actuator_force", "act_dot"))
  assert run.gaps.max() <= 1e-10, run.gaps
  for f in ("actuator_force", "act_dot"):
    assert_close(run.port[f], run.jax[f], 1e-10, f)
  assert np.abs(run.port["act"]).max() > 0.1  # the muscle activates


_NONE_XML = """
<mujoco><option timestep="0.002" integrator="implicitfast"/>
  <worldbody>
    <body pos="0 0 1"><joint name="j" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" contype="0" conaffinity="0"/></body>
  </worldbody>
  <actuator><general joint="j" biastype="none" gainprm="2" biasprm="0 0 -5"/></actuator>
</mujoco>"""


def _implicitfast_runs(name: str):
  """300 implicitfast substeps of the joint muscle (controls 0.9, 0.2, 1.0,
  100 steps each) or the biastype-none hinge (ctrl 0.7) in MuJoCo, the JAX
  package and the port."""
  import jax

  from mjlab_tpu import physics as jphysics
  from mjlab_tpu_torch import physics as tphysics
  from mjlab_tpu_torch.physics import io as tio
  from tests.torch_parity import jax_data_from_arrays

  if name == "joint_muscle":
    from mjlab_tpu_torch.assets.muscle_scenes import SCENES

    xml = SCENES[name].xml.replace('<option timestep="0.002"/>',
                                   '<option timestep="0.002" integrator="implicitfast"/>')

    def ctrl(k):
      return np.array([(0.9, 0.2, 1.0)[k // 100]])
  else:
    xml = _NONE_XML

    def ctrl(k):
      return np.array([0.7])
  mj = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mj)
  # Both engines at 2 Newton iterations: the one limit row converges in one.
  fast = mujoco.MjModel.from_xml_string(xml)
  fast.opt.iterations, fast.opt.ls_iterations = 2, 4
  jtp, jm = jphysics.put_model(fast, dtype=jnp.float64)
  ttp, tm = tio.put_model(fast, dtype=torch.float64, device="cpu")
  td = tphysics.make_data(ttp, tm, 1)
  d = jax_data_from_arrays({k: v[0] for k, v in tio.data_to_arrays(td).items()})
  ctrls = np.stack([ctrl(k) for k in range(300)])
  # The JAX package's 300 substeps in one call.
  d = jax.jit(lambda dd, cs: jax.lax.scan(
    lambda x, c: (jphysics.step(jtp, jm, x.replace(ctrl=c)), None), dd, cs)[0])(
      d, jnp.asarray(ctrls))
  with torch.inference_mode():
    for c in ctrls:
      mjd.ctrl[:] = c
      mujoco.mj_step(mj, mjd)
      td = tphysics.step(ttp, tm, td.replace(ctrl=torch.tensor(c[None])))
  return mjd, d, td


@pytest.mark.parametrize("name", ["joint_muscle", "biastype_none"])
def test_implicitfast_actuator_derivative_is_mujocos(name):
  """Under implicitfast the port equals mujoco.mj_step within 1e-9 after
  300 substeps; the JAX package, which adds every actuator's −biasprm[2]
  to the implicit matrix and no muscle force-velocity slope, misses MuJoCo
  by more than 1e-3 there (qvel 6.1e-3 on the joint muscle, 24.8 on the
  hinge)."""
  with torch_threads(1):
    mjd, d, td = _implicitfast_runs(name)
  for f in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(getattr(td, f).numpy()[0], getattr(mjd, f), rtol=0, atol=1e-9,
                               err_msg=f)
  assert np.max(np.abs(np.asarray(d.qvel) - mjd.qvel)) > 1e-3


def test_arm_equals_jax_under_euler():
  """The musculoskeletal arm (five muscles on wrapped and pulley tendons, a
  filterexact and an integrator actuator with actrange, fluid forces)
  under Euler, 30 substeps: qpos, qvel and act within 1e-10 of JAX's at
  every step; the tendons' lengths, Jacobians and velocities, the actuator
  force and tendon length sensors too (the actuatorpos/vel sensors read this forward's transmission in the
  port, the last forward's in the JAX package: ROADMAP Queue C)."""
  with torch_threads(1):
    run = muscle_rollout("muscle_arm", 30, integrator=mjtIntegrator.mjINT_EULER, budget=True,
                         record=("sensordata", "ten_length", "ten_J", "ten_velocity",
                                 "actuator_force"))
  assert run.gaps.max() <= 1e-10, run.gaps
  for f in ("ten_length", "ten_J", "ten_velocity", "actuator_force"):
    assert_close(run.port[f], run.jax[f], 1e-10, f)
  assert_close(run.port["sensordata"][:, 2:], run.jax["sensordata"][:, 2:], 1e-10, "sensordata")


def test_arm_equals_mujoco_under_implicitfast():
  """The arm under its own implicitfast, 30 substeps, against
  mujoco.mj_step (the JAX package's implicit matrix is not MuJoCo's for
  muscles): qpos, qvel, act and every sensor within 1e-9, and some muscle
  wraps its geom."""
  with torch_threads(1):
    run = muscle_rollout("muscle_arm", 30, mjc=True, with_jax=False, budget=True,
                         record=("sensordata",))
  for i, f in enumerate(("qpos", "qvel", "act")):
    np.testing.assert_allclose(run.port[f][0], run.mujoco[i], rtol=0, atol=1e-9, err_msg=f)
  np.testing.assert_allclose(run.port["sensordata"][0], run.mjd.sensordata, rtol=0, atol=1e-9)
