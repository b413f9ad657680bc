"""The port's equality, dof friction-loss and tendon-limit rows against the
JAX package (mjlab_tpu/physics/constraint.py) and MuJoCo, float64, CPU.

Each scene of mjlab_tpu_torch/assets/solver_scenes.py with such rows runs
its substeps in MuJoCo, the JAX package and the port side by side
(`torch_parity.solver_scene_run`, the port and JAX at 10 Newton iterations
of 20 linesearch steps, which converge these scenes). At the first and the
middle step the port's rows, built from the JAX state, must equal JAX's
(efc_J, efc_D, efc_aref, efc_frictionloss, efc_pos, efc_margin) within
1e-9 relative to max(1, max |JAX|), and one port substep from that state
JAX's within 1e-8; the whole trajectory must stay within 1e-6 of JAX's and
within the JAX tests' own tolerance of MuJoCo's (qpos; qvel at 10x), as
tests/test_physics_equality.py, test_physics_contacts.py and
test_physics_tendon_spatial.py hold the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from tests.torch_parity import assert_close, solver_scene_run, to_torch, torch_threads

# scene: (substeps, tolerance against MuJoCo), the JAX tests' own.
SCENES = {
  "connect_fourbar": (200, 1e-7),
  "connect_sites": (200, 1e-7),
  "weld_pair": (150, 1e-6),
  "weld_sites": (150, 1e-6),
  "joint_coupling": (200, 1e-7),
  "tendon_coupling": (200, 1e-7),
  "connect_with_contact": (150, 1e-5),
  "frictionloss": (200, 1e-6),
  "tendon_limit": (200, 1e-7),
}
ROW_FIELDS = ("efc_J", "efc_D", "efc_aref", "efc_frictionloss", "efc_pos", "efc_margin")


@pytest.mark.parametrize("name", list(SCENES))
def test_rows_substep_and_trajectory_match_jax_and_mujoco(name):
  steps, tol = SCENES[name]
  with torch_threads(1):
    run = solver_scene_run(name, steps, checks=(0, steps // 2))
    kinds = (run.ttp.neq_rows, len(run.ttp.friction_dof_ids), len(run.ttp.limited_tendon_ids))
    assert kinds == (run.jtp.neq_rows, len(run.jtp.friction_dof_ids),
                     len(run.jtp.limited_tendon_ids))
    assert sum(kinds) > 0
    for pre, post in run.stages:
      at_pre = {**post, "qpos": pre["qpos"], "qvel": pre["qvel"]}
      rows = tio.data_to_arrays(tcon.make_constraint(run.ttp, run.tm, to_torch(at_pre)))
      for f in ROW_FIELDS:
        assert_close(rows[f], post[f], 1e-9, f"{name}: {f}")
      one = tio.data_to_arrays(tphysics.step(run.ttp, run.tm, to_torch(pre)))
      for f in ("qpos", "qvel", "qacc", "efc_force"):
        assert_close(one[f], post[f], 1e-8, f"{name}: one substep's {f}")
  for i, what in enumerate(("qpos", "qvel")):
    assert_close(run.port[i], run.jax[i], 1e-6, f"{name}: {what} after {steps} substeps")
  np.testing.assert_allclose(run.port[0][0], run.mujoco[0], atol=tol)
  np.testing.assert_allclose(run.port[1][0], run.mujoco[1], atol=10 * tol)


def test_friction_rows_cost_is_huber():
  """The friction-loss row's force saturates at ±frictionloss (the Huber
  cost's slope), and the rows of every dof are allocated on request."""
  from tests.torch_parity import solver_scene_model

  mj = solver_scene_model("frictionloss")
  tp, m = tio.put_model(mj, dtype=torch.float64, device="cpu", allocate_friction_rows=True)
  assert list(tp.friction_dof_ids) == list(range(mj.nv))
  # World 0 slides fast; world 1 hangs straight down, nearly at rest.
  d = tio.make_data(tp, m, 2).replace(
    qpos=torch.tensor([[0.0], [np.pi / 2]], dtype=torch.float64),
    qvel=torch.tensor([[3.0], [1e-4]], dtype=torch.float64))
  d = tphysics.forward(tp, m, d)
  fl = float(mj.dof_frictionloss[0])
  assert torch.allclose(d.efc_frictionloss, torch.full_like(d.efc_frictionloss, fl))
  assert abs(abs(float(d.efc_force[0, 0])) - fl) < 1e-12  # sliding: saturated
  assert abs(float(d.efc_force[1, 0])) < fl  # near rest: inside the quadratic zone


TENDON_AND_CONTACT_XML = """
<mujoco><option timestep="0.002" cone="elliptic"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body pos="0 0 1"><joint name="a" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" contype="0" conaffinity="0"/>
      <body pos="0.3 0 0"><joint name="b" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03" contype="0" conaffinity="0"/></body>
    </body>
    <body pos="1 0 0.099"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
  <tendon>
    <fixed name="t" limited="true" range="-0.3 0.4"><joint joint="a" coef="0.8"/>
      <joint joint="b" coef="-0.5"/></fixed>
  </tendon>
</mujoco>"""


def test_contact_rows_follow_the_tendon_limit_rows():
  """With a limited tendon and an elliptic contact, the contact's rows lie
  after the tendon-limit row: the port's cone slots and contact_forces
  read them there. The JAX package's efc_row_types counts the tendon-limit
  row as a contact row, so its contact_forces (and its cone grouping) read
  one row early (ROADMAP Queue C); its rows themselves are the port's."""
  import jax
  import jax.numpy as jnp
  import mujoco

  from mjlab_tpu import physics as jphysics
  from mjlab_tpu.physics import constraint as jcon
  from tests.torch_parity import jax_data_arrays

  mj = mujoco.MjModel.from_xml_string(TENDON_AND_CONTACT_XML)
  mjd = mujoco.MjData(mj)
  mujoco.mj_forward(mj, mjd)
  mj.opt.iterations, mj.opt.ls_iterations = 10, 20
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  tp, m = tio.put_model(mj, dtype=torch.float64, device="cpu")
  assert tp.nefc == jtp.nefc == 1 + 3
  assert tcon.contact_slot_row_adr(tp, 1).tolist() == [1]
  assert jcon.contact_slot_row_adr(jtp, 1).tolist() == [0]
  jd = jax.jit(lambda d: jphysics.forward(jtp, jm, d))(jphysics.make_data(jtp, jm))
  want = jax_data_arrays(jax.tree_util.tree_map(lambda x: x[None], jd))
  d = tphysics.forward(tp, m, to_torch(want))
  assert_close(d.efc_J.numpy(), want["efc_J"], 1e-9, "efc_J")
  f = d.efc_force[0].numpy()
  assert f[1] > 0  # the sphere rests on the floor
  np.testing.assert_allclose(tcon.contact_forces(tp, m, d)[0, 0, :3].numpy(), f[1:4])
  np.testing.assert_allclose(d.qacc[0].numpy(), mjd.qacc, atol=1e-6)  # MuJoCo's
  jf = np.asarray(jcon.contact_forces(jtp, jm, jd))
  assert np.allclose(jf[0, :3], want["efc_force"][0, 0:3])  # one row early
