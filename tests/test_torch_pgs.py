"""The PGS solver in the port (physics/solver.py `_pgs`, through
kernels/pgs.py) against the JAX package's pgs_solve, float64 on the CPU:
the JAX test's rig (pyramidal contacts, a joint limit and dof friction
loss: every dual projection) and an equality scene (connect and joint
equalities, unbounded dual rows, beside a joint limit), stepped side by
side (mjlab_tpu_torch/assets/muscle_scenes.py `pgs_*`; the rig in
mujoco.mj_step too, in the same rollout). No PGS scene here
combines a limited tendon with contacts: the port orders contact rows
after the tendon-limit rows and the JAX package does not (ROADMAP Queue C),
and Gauss-Seidel depends on the row order. The kernel's own tests are in
tests/test_torch_pgs_kernel.py."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import pgs
from mjlab_tpu_torch.physics.types import mjtSolver
from tests.torch_parity import assert_close, muscle_models, muscle_rollout, torch_threads


@functools.cache
def _rollout(name: str):
  """The scene's rollout beside the JAX package (the rig 50 substeps, also
  in mujoco.mj_step; the equality scene 40), and pgs_solve's kernel
  launches during it."""
  pgs.reset_counts()
  with torch_threads(1):
    run = muscle_rollout(name, 50 if name == "pgs_rig" else 40, mjc=name == "pgs_rig",
                         record=("efc_force", "qfrc_constraint", "qacc"))
  return run, pgs.LAUNCHES["pgs_solve"]


@pytest.mark.parametrize("name", ["pgs_rig", "pgs_equality"])
def test_pgs_equals_jax(name):
  """qpos, qvel within 1e-8 relative of JAX's at every step, the dual forces
  and the constraint force at the end; the solve went through
  kernels.pgs.pgs_solve's plain path (a CPU tensor: no launch)."""
  run, launches = _rollout(name)
  assert run.tm.opt.solver == run.jm.opt.solver == mjtSolver.mjSOL_PGS
  assert run.gaps.max() <= 1e-8, run.gaps
  for f in ("efc_force", "qfrc_constraint", "qacc"):
    assert_close(run.port[f], run.jax[f], 1e-8, f)
  assert np.abs(run.port["efc_force"]).max() > 1e-3  # rows are active
  assert launches == 0


def test_pgs_rig_tracks_mujoco():
  """The rig's first 50 substeps against mujoco.mj_step, to the JAX test's
  bounds (the dual optimum is unique, but PGS at 100 sweeps and MuJoCo's
  own PGS differ in detail): qpos within 2e-3, qvel within 0.05."""
  run, _ = _rollout("pgs_rig")
  np.testing.assert_allclose(run.port["qpos"][0], run.mujoco[0], rtol=0, atol=2e-3)
  assert np.linalg.norm(run.port["qvel"][0] - run.mujoco[1]) < 0.05


def test_pgs_solve_forms_the_jax_bounds():
  """One forward of the rig: the solver hands pgs_solve a0 = qacc_smooth,
  aref and each row's box (friction-loss rows ±fl, limit and contact rows
  [0, ∞), inactive rows [0, 0]), and takes qacc = qacc_smooth + u and
  qfrc_constraint from it."""
  from mjlab_tpu_torch import physics as tphysics
  from mjlab_tpu_torch.assets import muscle_scenes

  mj, _, (ttp, tm) = muscle_models("pgs_rig", with_jax=False)
  calls = []
  plain = pgs.pgs_solve

  def spy(L, J, a0, aref, D, lo, hi, iterations):
    out = plain(L, J, a0, aref, D, lo, hi, iterations)
    calls.append((a0.clone(), aref.clone(), D.clone(), lo.clone(), hi.clone(), iterations,
                  [t.clone() for t in out]))
    return out

  qpos, qvel = muscle_scenes.SCENES["pgs_rig"].state(mj)
  d = tphysics.make_data(ttp, tm, 1).replace(qpos=torch.tensor(qpos[None]),
                                             qvel=torch.tensor(qvel[None]))
  pgs.pgs_solve = spy
  try:
    with torch_threads(1):
      d = tphysics.forward(ttp, tm, d)
  finally:
    pgs.pgs_solve = plain
  (a0, aref, D, lo, hi, iterations, (_, u, qfrc)), = calls
  assert iterations == 100
  assert torch.equal(a0, d.qacc_smooth) and torch.equal(aref, d.efc_aref)
  assert torch.equal(d.qacc, d.qacc_smooth + u) and torch.equal(d.qfrc_constraint, qfrc)
  fl = d.efc_frictionloss[0, 0].item()
  active = D[0] > 0
  assert lo[0, 0].item() == -fl and hi[0, 0].item() == fl and fl > 0
  assert torch.all(lo[0, 1:][active[1:]] == 0) and torch.all(torch.isinf(hi[0, 1:][active[1:]]))
  assert torch.all(lo[0][~active] == 0) and torch.all(hi[0][~active] == 0)
