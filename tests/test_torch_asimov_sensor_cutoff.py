"""Sensor cutoff, a fault of the reference that the port mirrors on purpose.

Asimov's `imu_accel` has cutoff 157 and `imu_gyro` cutoff 34.9
(asimov.xml:137-138). MuJoCo clamps a real-valued sensor to ±cutoff; the
JAX package's sensors read no `sensor_cutoff` at all. In a foot impact (the
keyframe dropped onto the floor at 10 m/s) the accelerometer reads past
157 m/s² in the JAX package and in the port, which agree, while
`mujoco.mj_step` reads exactly 157 on the clamped axes.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch.physics import io as tio
from tests.torch_parity import assert_close, jax_data_arrays, scene, to_torch

IMPACT_VZ = -10.0
tfwd = importlib.import_module("mjlab_tpu_torch.physics.forward")


def test_imu_accel_is_not_clamped_at_its_cutoff_as_mujoco_clamps_it():
  sc = scene("asimov")
  m = sc.mj
  sid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_SENSOR, "robot/imu_accel")
  adr, cutoff = int(m.sensor_adr[sid]), float(m.sensor_cutoff[sid])
  assert cutoff == 157.0

  d = mujoco.MjData(m)
  d.qpos[:] = m.key_qpos[0]
  d.qvel[2] = IMPACT_VZ
  mujoco.mj_step(m, d)
  mj_accel = d.sensordata[adr:adr + 3].copy()

  qvel = np.zeros(m.nv)
  qvel[2] = IMPACT_VZ
  jd = jphysics.make_data(sc.jtp, sc.jm).replace(
    qpos=jnp.asarray(m.key_qpos[0]), qvel=jnp.asarray(qvel)
  )
  jd = jax.tree_util.tree_map(lambda x: x[None], jd)
  want = jax_data_arrays(jax.jit(jax.vmap(lambda d: jphysics.step(sc.jtp, sc.jm, d)))(jd))
  got = tio.data_to_arrays(tfwd.step(sc.ttp, sc.tm, to_torch(jax_data_arrays(jd))))
  jax_accel = want["sensordata"][0, adr:adr + 3]

  # MuJoCo clamps: its largest axis sits exactly on the cutoff.
  assert np.abs(mj_accel).max() == cutoff
  # The JAX package does not: the same impact reads past the cutoff ...
  assert np.abs(jax_accel).max() > cutoff
  # ... and the port mirrors it.
  assert_close(got["sensordata"], want["sensordata"], 1e-8, "sensordata")
  assert np.abs(got["sensordata"][0, adr:adr + 3]).max() > cutoff
