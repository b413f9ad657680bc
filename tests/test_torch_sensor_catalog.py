"""The sensor catalog, the port against the JAX package (float64, CPU) and
MuJoCo: each sensor of the JAX package's sensor test scenes and of the
small humanoid (every type the port added in PR 13: joint, tendon,
actuator, subtree, limit, IMU and frame-acceleration sensors, the
energies, the clock, force, torque, touch, rangefinder and tendon actuator
force), evaluated by the port's sensor stages on the JAX package's
post-forward state, within 1e-9 of the JAX package's value (PERF.md §2).

Two sensors give MuJoCo's value where the JAX package does not (ROADMAP
Queue C), each shown against `mujoco.mj_forward` with the JAX package's
value apart: frame sensors with a reference frame, and actuatorpos and
actuatorvel on the first forward of a state. The catalog binds by name
(`BuiltinSensor`, the JAX package's type names).
"""

from __future__ import annotations

import jax
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.surface_scenes import SCENES
from mjlab_tpu_torch.physics import sensors as tsensors
from mjlab_tpu_torch.physics.types import mjtSensor
from tests.torch_parity import assert_close, one_world, surface_data, surface_models, \
  to_torch, torch_threads

STAGE_TOL = 1e-9
_S = mujoco.mjtSensor
# Read this forward's transmission in the port, the previous forward's in
# the JAX package: compared with MuJoCo below.
_TRANSMISSION = (int(_S.mjSENS_ACTUATORPOS), int(_S.mjSENS_ACTUATORVEL))
_SCENES = ("sensor_rig", "ft_rig", "humanoid")
# The types the port's catalog added in PR 13 (the 11 before: IMU, frame
# and subtree angular momentum).
NEW_TYPES = {
  "jointpos", "jointvel", "subtreecom", "subtreelinvel", "actuatorpos", "actuatorvel",
  "actuatorfrc", "magnetometer", "clock", "tendonpos", "tendonvel", "jointlimitpos",
  "jointlimitvel", "jointlimitfrc", "jointactuatorfrc", "framelinacc", "frameangacc",
  "e_potential", "e_kinetic", "force", "torque", "touch", "rangefinder",
  "tendonactuatorfrc",
}


def _state(name: str, mj):
  """The scene's state: the JAX test's for the two rigs; the humanoid
  after 10 MuJoCo steps of seeded joint velocities and controls."""
  if name != "humanoid":
    return None
  mjd = mujoco.MjData(mj)
  rng = np.random.default_rng(3)
  mjd.qvel[6:] = rng.normal(0, 0.3, mj.nv - 6)
  mjd.ctrl[:] = rng.uniform(-0.1, 0.1, mj.nu)
  for _ in range(10):
    mujoco.mj_step(mj, mjd)
  return mjd


@pytest.fixture(scope="module", params=_SCENES)
def scene(request):
  """Per scene: the JAX forward, the port's sensor stages on its state,
  MuJoCo's mj_forward on the same state, and the models."""
  name = request.param
  mj, (jtp, jm), (ttp, tm) = surface_models(name)
  mjd = _state(name, mj)
  if mjd is None:
    d, _ = surface_data(name, jtp, jm)
    mjd = mujoco.MjData(mj)
    mjd.qpos[:], mjd.qvel[:], mjd.ctrl[:] = (np.asarray(x) for x in (d.qpos, d.qvel, d.ctrl))
    mjd.time = float(d.time)
  else:
    d, _ = surface_data(name, jtp, jm, qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy())
    d = d.replace(ctrl=jax.numpy.asarray(mjd.ctrl.copy()))
  mujoco.mj_forward(mj, mjd)
  want = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d)
  arrays = one_world(want)
  pre = to_torch({**arrays, "sensordata": np.zeros_like(arrays["sensordata"])})
  with torch_threads(1):
    got = tsensors.sensor_acc(ttp, tm, tsensors.sensor_vel(
      ttp, tm, tsensors.sensor_pos(ttp, tm, pre)))
  return dict(name=name, mj=mj, mjd=mjd, jtp=jtp, jm=jm, ttp=ttp, tm=tm, d=d,
              want=arrays["sensordata"][0], got=got.sensordata[0].numpy())


def _slices(mj):
  for s in range(mj.nsensor):
    adr, dim = int(mj.sensor_adr[s]), int(mj.sensor_dim[s])
    yield s, mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_SENSOR, s), slice(adr, adr + dim)


def test_each_sensor_equals_jax(scene):
  """Every sensor without a reference frame, other than the two that read
  the transmission, at 1e-9 of the JAX package's on its own state."""
  mj = scene["mj"]
  checked = 0
  for s, name, sl in _slices(mj):
    if mj.sensor_refid[s] >= 0 or int(mj.sensor_type[s]) in _TRANSMISSION:
      continue
    assert_close(scene["got"][sl], scene["want"][sl], STAGE_TOL, f"{scene['name']}/{name}")
    checked += 1
  assert checked >= 7


def test_each_sensor_equals_mujoco(scene):
  """Every sensor against mj_forward on the same state, the port at the
  compiled solver budget (100 Newton iterations of 50 linesearch steps):
  the sensor formulas agree to 1e-9, and those of the acceleration stage,
  which read the constraint forces, to the solve's convergence. The
  humanoid runs under the elliptic cone here: its capsule–plane contacts
  take a tangent frame other than MuJoCo's in both packages (ROADMAP Queue
  C), which turns the pyramid's facets but leaves a round cone's forces
  as they are."""
  mj, mjd = scene["mj"], scene["mjd"]
  if scene["name"] == "humanoid":
    mj.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
    mujoco.mj_forward(mj, mjd)
  _, _, (ttp, tm) = surface_models(scene["name"], budget=False, cone=int(mj.opt.cone))
  with torch_threads(1):
    _, td = surface_data(scene["name"], scene["jtp"], scene["jm"], qpos=mjd.qpos.copy(),
                         qvel=mjd.qvel.copy())
    td = td.replace(ctrl=torch.tensor(mjd.ctrl[None].copy()),
                    time=torch.tensor([mjd.time], dtype=torch.float64))
    got = tphysics.forward(ttp, tm, td).sensordata[0].numpy()
  for s, name, sl in _slices(mj):
    acc = int(mj.sensor_type[s]) in tsensors._ACC_STAGE
    np.testing.assert_allclose(got[sl], mjd.sensordata[sl], rtol=1e-5 if acc else 1e-9,
                               atol=1e-5 if acc else 1e-9, err_msg=name)


def test_reference_frames_are_mujocos():
  """The humanoid's frame sensors in five reference frames (site, xbody,
  body, geom): the port's equal mj_forward's; the JAX package's, which
  reads no reference frame, are world-frame values far from them."""
  mj, (jtp, jm), (ttp, tm) = surface_models("humanoid")
  mjd = _state("humanoid", mj)
  mujoco.mj_forward(mj, mjd)
  d, td = surface_data("humanoid", jtp, jm, qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy())
  jd = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d)
  with torch_threads(1):
    got = tphysics.forward(ttp, tm, td).sensordata[0].numpy()
  refs = [(s, n, sl) for s, n, sl in _slices(mj) if mj.sensor_refid[s] >= 0]
  assert {int(mj.sensor_reftype[s]) for s, _, _ in refs} == {1, 2, 5, 6}
  assert len({int(mj.sensor_type[s]) for s, _, _ in refs}) == 6
  for s, name, sl in refs:
    np.testing.assert_allclose(got[sl], mjd.sensordata[sl], atol=1e-12, err_msg=name)
    assert np.abs(np.asarray(jd.sensordata)[sl] - mjd.sensordata[sl]).max() > 1e-3, name


def test_actuator_sensors_read_this_forward():
  """actuatorpos and actuatorvel on a state's first forward: the port's
  equal MuJoCo's; the JAX package's read the Data's previous
  actuator_length and actuator_velocity (zeros here)."""
  mj, (jtp, jm), (ttp, tm) = surface_models("humanoid")
  mjd = _state("humanoid", mj)
  mujoco.mj_forward(mj, mjd)
  d, td = surface_data("humanoid", jtp, jm, qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy())
  jd = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d)
  with torch_threads(1):
    got = tphysics.forward(ttp, tm, td).sensordata[0].numpy()
  rows = [(n, sl) for s, n, sl in _slices(mj) if int(mj.sensor_type[s]) in _TRANSMISSION]
  assert len(rows) == 2
  for name, sl in rows:
    np.testing.assert_allclose(got[sl], mjd.sensordata[sl], atol=1e-12, err_msg=name)
    assert np.asarray(jd.sensordata)[sl] == 0.0 != mjd.sensordata[sl]


def test_sensor_types_bind_by_name():
  """The port's SENSOR_TYPES are the JAX package's _SENSOR_TYPES (names and
  values); each scene sensor binds by name to its type and slice."""
  from types import SimpleNamespace

  from mjlab_tpu.sensors.builtin_sensor import _SENSOR_TYPES
  from mjlab_tpu_torch.assets import surface_scenes
  from mjlab_tpu_torch.sensors.builtin_sensor import SENSOR_TYPES, BuiltinSensor

  assert SENSOR_TYPES == {k: int(v) for k, v in _SENSOR_TYPES.items()}
  seen = set()
  for name in _SCENES:
    m = surface_scenes.load(name)
    for s in range(m.nsensor):
      mj_name = mujoco.mj_id2name(mujoco.MjModel.from_xml_string(SCENES[name].xml),
                                  mujoco.mjtObj.mjOBJ_SENSOR, s)
      sensor = BuiltinSensor.from_existing(mj_name)
      sensor.initialize(m, SimpleNamespace())
      assert SENSOR_TYPES[sensor.sensor_type] == int(m.sensor_type[s])
      assert (sensor._adr, sensor._dim) == (int(m.sensor_adr[s]), int(m.sensor_dim[s]))
      seen.add(sensor.sensor_type)
  assert NEW_TYPES <= seen, NEW_TYPES - seen
  assert {v for k, v in vars(mjtSensor).items() if k.startswith("mjSENS_")} == set(
    SENSOR_TYPES.values())
