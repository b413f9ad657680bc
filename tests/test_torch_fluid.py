"""The inertia-box fluid model in the port (smooth.fluid_box, and its
velocity derivative in the implicitfast matrix), float64 on the CPU: the
JAX test's rig (a free torso and two hinged links,
mjlab_tpu_torch/assets/muscle_scenes.py `fluid_*`) under its four fluid
settings, the force and its derivative against the JAX package at seeded
states, and rollouts under Euler and implicitfast against mujoco.mj_step,
as the JAX test holds the JAX package."""

from __future__ import annotations

import jax
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.muscle_scenes import SCENES
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import smooth as tsmooth
from mjlab_tpu_torch.physics.types import mjtIntegrator
from tests.torch_parity import (
  assert_close,
  jax_data_from_arrays,
  muscle_models,
  muscle_rollout,
  torch_threads,
)

_SETTINGS = ("all", "density", "viscosity", "wind")
_INTEGRATORS = {"Euler": mjtIntegrator.mjINT_EULER,
                "implicitfast": mjtIntegrator.mjINT_IMPLICITFAST}


def _check_mujoco(run, fluid):
  """The rollout's end against mujoco.mj_step at the JAX test's tolerances
  (qpos 1e-8, qvel 1e-7), and the first forward's passive force within
  1e-10."""
  np.testing.assert_allclose(run.port["qpos"][0], run.mujoco[0], rtol=0, atol=1e-8)
  np.testing.assert_allclose(run.port["qvel"][0], run.mujoco[1], rtol=0, atol=1e-7)
  mjd = mujoco.MjData(run.mj)
  mjd.qpos[:], mjd.qvel[:] = SCENES[f"fluid_{fluid}"].state(run.mj)
  mujoco.mj_forward(run.mj, mjd)
  td = tphysics.make_data(run.ttp, run.tm, 1).replace(
    qpos=torch.tensor(mjd.qpos[None]), qvel=torch.tensor(mjd.qvel[None]))
  td = tphysics.forward(run.ttp, run.tm, td)
  np.testing.assert_allclose(td.qfrc_passive[0].numpy(), mjd.qfrc_passive, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def jax_fluid_forward():
  """The JAX package's forward and its fluid derivative there, jax.jacfwd
  through com_vel ∘ _fluid_box (forward.py:79-90), vmapped over states
  and jitted once for the rig's Topology (the four settings share it)."""
  from mjlab_tpu.physics import smooth as jsmooth

  jtp = muscle_models("fluid_all")[1][0]

  def one(m, d):
    d = jphysics.forward(jtp, m, d)
    return d, jax.jacfwd(
      lambda v: jsmooth._fluid_box(jtp, m, jsmooth.com_vel(jtp, m, d.replace(qvel=v))))(d.qvel)

  return jax.jit(jax.vmap(one, in_axes=(None, 0)))


@pytest.mark.parametrize("fluid", _SETTINGS)
def test_implicit_derivative_equals_jacfwd(fluid, jax_fluid_forward):
  """At five seeded states of the rig, against the JAX package within 1e-10
  relative: the passive force (the inertia-box fluid force beside the
  joints' damping) and qacc after a forward, and the closed-form
  ∂qfrc_fluid/∂qvel (smooth.fluid_box_qvel_derivative, which the
  implicitfast matrix takes masked to M's tree sparsity) against jacfwd."""
  mj, (jtp, jm), (ttp, tm) = muscle_models(f"fluid_{fluid}")
  assert ttp.has_fluid and jtp.has_fluid
  rng = np.random.default_rng(5)
  qpos, qvel = [], []
  for _ in range(5):
    q, _ = SCENES[f"fluid_{fluid}"].state(mj)
    q[:3] += 0.2 * rng.standard_normal(3)
    q[3:7] = rng.standard_normal(4)
    q[3:7] /= np.linalg.norm(q[3:7])
    q[7:] += rng.standard_normal(mj.nq - 7)
    qpos.append(q)
    qvel.append(2.0 * rng.standard_normal(mj.nv))
  td = tphysics.make_data(ttp, tm, 5).replace(qpos=torch.tensor(np.stack(qpos)),
                                              qvel=torch.tensor(np.stack(qvel)))
  jd, want = jax_fluid_forward(jm, jax_data_from_arrays(tio.data_to_arrays(td)))
  with torch_threads(1), torch.inference_mode():
    td = tphysics.forward(ttp, tm, td)
    got = tsmooth.fluid_box_qvel_derivative(ttp, tm, td).numpy()
  assert_close(got, np.asarray(want), 1e-10, f"d qfrc_fluid / d qvel ({fluid})")
  assert np.abs(np.asarray(want)).max() > 1e-3
  for f in ("qfrc_passive", "qacc"):
    assert_close(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), 1e-10, f)
  assert np.abs(td.qfrc_passive.numpy()).max() > 1e-3


def _rollout_against_mujoco(fluid: str, integrator: str) -> None:
  """50 substeps from the JAX test's seeded state against mujoco.mj_step,
  as the JAX test holds the JAX package."""
  with torch_threads(1):
    run = muscle_rollout(f"fluid_{fluid}", 50, _INTEGRATORS[integrator], mjc=True,
                         with_jax=False)
  assert run.ttp.has_fluid
  _check_mujoco(run, fluid)


@pytest.mark.parametrize("fluid", _SETTINGS)
def test_fluid_equals_mujoco_under_implicitfast(fluid):
  """50 implicitfast substeps against mujoco.mj_step at the JAX test's
  tolerances (qpos 1e-8, qvel 1e-7), and the first forward's passive force
  within 1e-10."""
  _rollout_against_mujoco(fluid, "implicitfast")


@pytest.mark.parametrize("fluid", _SETTINGS)
def test_fluid_equals_mujoco_under_euler(fluid):
  """The same under Euler."""
  _rollout_against_mujoco(fluid, "Euler")
