"""Stage-by-stage parity of the PyTorch port against the JAX package.

Both engines run in float64 on the CPU on the same 8 contact-rich states of
each scene (a JAX rollout from the keyframe, tests/torch_parity.py). Each
stage is fed the same input state and its outputs are compared with
max|port − jax| <= tol · max(1, max|jax|):
  * 1e-9 for smooth quantities (kinematics, CoM, mass matrix and factor,
    bias/passive/actuator forces, collision, constraint rows, sensors);
  * 1e-8 for efc_force / qacc after the 10 Newton iterations, whose
    Cholesky factors and exact linesearch amplify last-bit differences.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from mjlab_tpu.physics import collision as jcoll
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import kinematics as jkin
from mjlab_tpu.physics import sensors as jsens
from mjlab_tpu.physics import smooth as jsmooth
from mjlab_tpu.physics import solver as jsolver
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import kinematics as tkin
from mjlab_tpu_torch.physics import sensors as tsens
from mjlab_tpu_torch.physics import smooth as tsmooth
from mjlab_tpu_torch.physics import solver as tsolver
from tests.torch_parity import (
  assert_close,
  jax_data_arrays,
  jax_data_from_arrays,
  scene,
  to_torch,
)

SMOOTH_TOL = 1e-9
SOLVER_TOL = 1e-8
SCENE_NAMES = ("toy", "g1", "asimov", "asimov_toe")


def _run_both(name, jfn, tfn, inputs=None):
  """Apply a JAX stage (vmapped) and the port's stage to the same state."""
  sc = scene(name)
  arrays = sc.states if inputs is None else inputs
  jd = jax.jit(jax.vmap(lambda d: jfn(sc.jtp, sc.jm, d)))(jax_data_from_arrays(arrays))
  td = tfn(sc.ttp, sc.tm, to_torch(arrays))
  return jax_data_arrays(jd), tio.data_to_arrays(td)


def _compare(name, jfn, tfn, fields, tol=SMOOTH_TOL, inputs=None):
  want, got = _run_both(name, jfn, tfn, inputs)
  for f in fields:
    assert_close(got[f], want[f], tol, f"{name}:{f}")


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_kinematics(name):
  _compare(
    name, jkin.kinematics, tkin.kinematics,
    ["xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "geom_xmat",
     "site_xpos", "site_xmat", "xanchor", "xaxis"],
  )


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_com_pos_and_vel(name):
  def jfn(tp, m, d):
    return jsmooth.com_vel(tp, m, jsmooth.com_pos(tp, m, d))

  def tfn(tp, m, d):
    return tsmooth.com_vel(tp, m, tsmooth.com_pos(tp, m, d))

  _compare(name, jfn, tfn, ["subtree_com", "cinert", "cdof", "cvel", "cdof_dot"])


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_crb_and_factor(name):
  def jfn(tp, m, d):
    return jsmooth.factor_m(tp, m, jsmooth.crb(tp, m, d))

  def tfn(tp, m, d):
    return tsmooth.factor_m(tp, m, tsmooth.crb(tp, m, d))

  _compare(name, jfn, tfn, ["qM", "qLD"])


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_smooth_forces_and_acceleration(name):
  def jfn(tp, m, d):
    for f in (jsmooth.rne, jsmooth.passive, jsmooth.fwd_actuation,
              jsmooth.fwd_acceleration):
      d = f(tp, m, d)
    return d

  def tfn(tp, m, d):
    for f in (tsmooth.rne, tsmooth.passive, tsmooth.fwd_actuation,
              tsmooth.fwd_acceleration):
      d = f(tp, m, d)
    return d

  _compare(
    name, jfn, tfn,
    ["qfrc_bias", "qfrc_spring", "qfrc_damper", "qfrc_passive",
     "actuator_length", "actuator_velocity", "actuator_force",
     "qfrc_actuator", "qfrc_smooth", "qacc_smooth"],
  )


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_collision(name):
  want, got = _run_both(name, jcoll.collision, tcoll.collision)
  for f in ("dist", "pos", "frame", "includemargin", "friction", "solref",
            "solimp", "solreffriction"):
    assert_close(got[f"contact.{f}"], want[f"contact.{f}"], SMOOTH_TOL, f)
  active = want["contact.dist"] < want["contact.includemargin"]
  assert active.sum() > 0, "states should be contact-rich"


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_make_constraint(name):
  want, got = _run_both(name, jcon.make_constraint, tcon.make_constraint)
  for f in ("efc_J", "efc_D", "efc_aref", "efc_pos", "efc_margin",
            "efc_frictionloss"):
    assert_close(got[f], want[f], SMOOTH_TOL, f)
  assert (want["efc_D"] > 0).sum() > 0


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_solve(name):
  want, got = _run_both(name, jsolver.solve, tsolver.solve)
  for f in ("qacc", "efc_force", "qfrc_constraint", "qacc_warmstart"):
    assert_close(got[f], want[f], SOLVER_TOL, f)
  assert (np.abs(want["efc_force"]) > 0).sum() > 0


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_sensors(name):
  def jfn(tp, m, d):
    return jsens.sensor_acc(tp, m, jsens.sensor_vel(tp, m, d))

  def tfn(tp, m, d):
    return tsens.sensor_acc(tp, m, tsens.sensor_vel(tp, m, d))

  _compare(name, jfn, tfn, ["sensordata", "subtree_linvel", "subtree_angmom"])
