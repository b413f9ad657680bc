"""Spatial tendons in the port (smooth.tendon: site chains, pulleys, sphere
and cylinder wrapping with and without a sidesite) against mujoco.mj_step,
as the JAX package's own tests hold it, float64 on the CPU: lengths,
Jacobians and velocities over seeded random configurations, and rollouts
with tendon springs, dampers, limit rows, a tendon actuator with its
sensors and a spatial-tendon equality (mjlab_tpu_torch/assets/
muscle_scenes.py). The port's spatial tendons run against the JAX package
at every substep in tests/test_torch_muscle.py: the tendon muscle (a limited
tendon) and the arm (sphere and sidesite-cylinder wraps, a pulley, tendon
sensors)."""

from __future__ import annotations

import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu_torch.physics import kinematics as tkin
from mjlab_tpu_torch.physics import smooth as tsmooth
from mjlab_tpu_torch.physics.types import mjtIntegrator
from tests.torch_parity import (
  assert_close,
  muscle_models,
  muscle_rollout,
  torch_threads,
)

_WRAPS = ("wrap_cylinder", "wrap_cylinder_side", "wrap_sphere", "wrap_sphere_side_neg",
          "wrap_sphere_side_pos")
_CONFIGS = 25


def _dense_ten_J(mj, mjd) -> np.ndarray:
  """MuJoCo's ten_J as a dense (ntendon, nv) matrix (it may be stored
  sparse)."""
  if mjd.ten_J.size == mj.ntendon * mj.nv:
    return mjd.ten_J.reshape(mj.ntendon, mj.nv).copy()
  J = np.zeros((mj.ntendon, mj.nv))
  for t in range(mj.ntendon):
    adr, nnz = mj.ten_J_rowadr[t], mj.ten_J_rownnz[t]
    J[t, mj.ten_J_colind[adr : adr + nnz]] = mjd.ten_J[adr : adr + nnz]
  return J


def _tendon_stage(name: str, seed: int):
  """The port's tendon stage (kinematics, com_pos, tendon) at _CONFIGS
  seeded configurations in [-2.8, 2.8] per joint and velocities, batched,
  and MuJoCo's ten_length, ten_J, ten_velocity and wrap counts."""
  from mjlab_tpu_torch import physics as tphysics

  mj, _, (ttp, tm) = muscle_models(name, with_jax=False)
  rng = np.random.default_rng(seed)
  qpos = rng.uniform(-2.8, 2.8, (_CONFIGS, mj.nq))
  qvel = rng.standard_normal((_CONFIGS, mj.nv))
  td = tphysics.make_data(ttp, tm, _CONFIGS).replace(qpos=torch.tensor(qpos),
                                                      qvel=torch.tensor(qvel))
  with torch_threads(1), torch.inference_mode():
    got = tsmooth.tendon(ttp, tm, tsmooth.com_pos(ttp, tm, tkin.kinematics(ttp, tm, td)))
  mjd = mujoco.MjData(mj)
  ref = {"ten_length": [], "ten_J": [], "ten_velocity": [], "wrapnum": []}
  for q, v in zip(qpos, qvel):
    mjd.qpos[:], mjd.qvel[:] = q, v
    mujoco.mj_forward(mj, mjd)
    ref["ten_length"].append(mjd.ten_length.copy())
    ref["ten_J"].append(_dense_ten_J(mj, mjd))
    ref["ten_velocity"].append(mjd.ten_velocity.copy())
    ref["wrapnum"].append(mjd.ten_wrapnum.copy())
  return got, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("name", _WRAPS + ("pulley", "spatial_cable", "muscle_arm"))
def test_lengths_jacobians_and_velocities(name):
  """At 25 seeded configurations: ten_length, ten_J and ten_velocity within
  1e-12 of MuJoCo's (the JAX test's tolerance); each wrap geom wraps at 3
  of them or more."""
  got, ref = _tendon_stage(name, seed=1)
  for f in ("ten_length", "ten_J", "ten_velocity"):
    assert_close(getattr(got, f).numpy(), ref[f], 1e-12, f)
  if name.startswith("wrap_"):
    assert (ref["wrapnum"][:, 0] > 2).sum() >= 3


def test_cable_equals_mujoco():
  """The cable's spring, damper, limit row (active for its first 8
  substeps), tendon motor and tendon sensors under implicitfast, 60
  substeps from the JAX test's state under its control against
  mujoco.mj_step at the JAX tests' tolerances: qpos 1e-8, qvel 1e-7, the
  actuator force 1e-8 and the sensors 1e-9."""
  with torch_threads(1):
    run = muscle_rollout("spatial_cable", 60, mjtIntegrator.mjINT_IMPLICITFAST, budget=True,
                         mjc=True, with_jax=False, record=("actuator_force", "sensordata"))
  np.testing.assert_allclose(run.port["qpos"][0], run.mujoco[0], rtol=0, atol=1e-8)
  np.testing.assert_allclose(run.port["qvel"][0], run.mujoco[1], rtol=0, atol=1e-7)
  np.testing.assert_allclose(run.port["actuator_force"][0], run.mjd.actuator_force,
                             rtol=0, atol=1e-8)
  np.testing.assert_allclose(run.port["sensordata"][0], run.mjd.sensordata, rtol=0, atol=1e-9)


def test_equality_equals_mujoco():
  """The spatial-tendon equality (the cable held to half a slide joint's
  travel), 30 Euler substeps against mujoco.mj_step at the JAX test's
  tolerances (qpos 1e-7, qvel 1e-6), its equality row active."""
  with torch_threads(1):
    run = muscle_rollout("spatial_equality", 30, mjtIntegrator.mjINT_EULER, budget=True,
                         mjc=True, with_jax=False, record=("efc_force",))
  assert run.ttp.neq_rows > 0 and np.abs(run.port["efc_force"]).max() > 1e-3
  np.testing.assert_allclose(run.port["qpos"][0], run.mujoco[0], rtol=0, atol=1e-7)
  np.testing.assert_allclose(run.port["qvel"][0], run.mujoco[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["pulley", "wrap_motor", "wrap_sphere", "wrap_cylinder_side"])
def test_rollout_equals_mujoco(name):
  """The pulley, the wrap with a motor on its tendon (Euler, as the JAX
  test runs them) and the sphere and sidesite cylinder wraps under a
  spring (implicitfast), 100 substeps against mujoco.mj_step at the JAX
  test's tolerances (qpos 1e-8, qvel 1e-7)."""
  integrator = (mjtIntegrator.mjINT_IMPLICITFAST if name.startswith("wrap_") and name != "wrap_motor"
                else mjtIntegrator.mjINT_EULER)
  with torch_threads(1):
    run = muscle_rollout(name, 100, integrator, mjc=True, with_jax=False,
                         record=("actuator_force",))
  np.testing.assert_allclose(run.port["qpos"][0], run.mujoco[0], rtol=0, atol=1e-8)
  np.testing.assert_allclose(run.port["qvel"][0], run.mujoco[1], rtol=0, atol=1e-7)
  if run.mj.nu:
    np.testing.assert_allclose(run.port["actuator_force"][0], run.mjd.actuator_force,
                               rtol=0, atol=1e-8)


def test_limit_engages():
  """The cable's range-limit row (1.45 m; the cable starts at 1.49) is
  active on the same substeps in the port as in mujoco.mj_step (the first
  8 of 40, Euler), pulls the length back under its limit, and qpos ends
  within 1e-7 of MuJoCo's."""
  from mjlab_tpu_torch import physics as tphysics
  from mjlab_tpu_torch.assets.muscle_scenes import SCENES

  sc = SCENES["spatial_cable"]
  _, _, (ttp, tm) = muscle_models("spatial_cable", mjtIntegrator.mjINT_EULER, budget=True,
                                  with_jax=False)
  mj = muscle_models("spatial_cable", mjtIntegrator.mjINT_EULER, with_jax=False)[0]
  assert ttp.limited_tendon_ids.tolist() == [0]
  mjd = mujoco.MjData(mj)
  qpos, qvel = sc.state(mj)
  mjd.qpos[:], mjd.qvel[:] = qpos, qvel
  d = tphysics.make_data(ttp, tm, 1).replace(qpos=torch.tensor(qpos[None]),
                                             qvel=torch.tensor(qvel[None]))
  engaged = []
  with torch_threads(1), torch.inference_mode():
    for k in range(40):
      c = sc.ctrl(k, mj.nu)
      mjd.ctrl[:] = c
      mujoco.mj_step(mj, mjd)
      d = tphysics.step(ttp, tm, d.replace(ctrl=torch.tensor(c[None])))
      engaged.append((bool((d.efc_force != 0).any()), mjd.nefc > 0 and bool((mjd.efc_force != 0).any())))
  port, ref = zip(*engaged)
  assert port == ref and sum(port) == 8
  assert float(d.ten_length[0, 0]) < 1.45
  np.testing.assert_allclose(d.qpos[0].numpy(), mjd.qpos, rtol=0, atol=1e-7)
