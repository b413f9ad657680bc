"""The elliptic friction cone and condim 4/6 in the port against the JAX
package (mjlab_tpu/physics/constraint.py, solver.py) and MuJoCo, float64,
CPU.

* The cone's cost, forces and Hessians: worlds of the puck scene placed in
  the top, middle and bottom zones run one Newton iteration with no
  linesearch steps in both packages, so that JAX's step (x0 + α·H⁻¹∇, its
  Hessian blocks inside H) and its forces are compared within 1e-9
  relative; the port's force must be minus the cost's gradient and its
  Hessian minus the force's Jacobian (central differences, 1e-6).
* contact_forces under both cones, within 1e-9 of JAX's.
* The puck and kicker scenes at two impratios, and the spinning ball at
  condim 4 and 6 under both cones: trajectories within 1e-6 of JAX's and
  within the JAX tests' tolerance of MuJoCo's (tests/test_physics_elliptic.py,
  test_physics_condim6.py), rows within 1e-9 and one substep within 1e-8.
* newton_direction_cone_plain on a state's real blocks against H formed
  in numpy and solved, 1e-10.
* One G1 velocity-flat substep under the elliptic cone (nefc 1320) from 8
  carried contact-rich states, within 1e-8 of JAX's (qvel and efc_force
  within 1e-7, at a cost tie; see the test).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.solver_scenes import SCENES
from mjlab_tpu_torch.kernels import chol
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import solver as tsolver
from mjlab_tpu_torch.physics.types import mjtCone
from tests.torch_parity import (
  assert_close,
  g1_mj_model,
  jax_data_arrays,
  jax_data_from_arrays,
  scene,
  solver_scene_model,
  solver_scene_run,
  to_torch,
  torch_threads,
)

PYR, ELL = mjtCone.mjCONE_PYRAMIDAL, mjtCone.mjCONE_ELLIPTIC
COST_TIE_TOL = 1e-7

KICKER_XML = """
<mujoco model="kicker">
  <option timestep="0.002" cone="elliptic" impratio="{imp}"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1"/>
    <body name="base" pos="0 0 0.45">
      <freejoint/>
      <geom name="torso" type="sphere" size="0.1" density="900"/>
      <body name="leg" pos="0 0 -0.1">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1.2 1.2"/>
        <geom name="shin" type="capsule" fromto="0 0 0 0 0 -0.3" size="0.04"/>
        <body name="foot" pos="0 0 -0.3">
          <joint name="ankle" type="hinge" axis="0 1 0" range="-1.0 1.0"/>
          <geom name="sole" type="capsule" fromto="-0.05 0 0 0.12 0 0"
                size="0.03" friction="0.9 0.005 0.0001"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position name="hip" joint="hip" kp="60" ctrlrange="-1.2 1.2"/>
    <position name="ankle" joint="ankle" kp="30" ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""


def _check_run(run, name, tol, steps):
  for pre, post in run.stages:
    at_pre = {**post, "qpos": pre["qpos"], "qvel": pre["qvel"]}
    rows = tio.data_to_arrays(tcon.make_constraint(run.ttp, run.tm, to_torch(at_pre)))
    for f in ("efc_J", "efc_D", "efc_aref", "efc_pos", "efc_margin"):
      assert_close(rows[f], post[f], 1e-9, f"{name}: {f}")
    one = tio.data_to_arrays(tphysics.step(run.ttp, run.tm, to_torch(pre)))
    for f in ("qpos", "qvel", "qacc", "efc_force"):
      assert_close(one[f], post[f], 1e-8, f"{name}: one substep's {f}")
  for i, what in enumerate(("qpos", "qvel")):
    assert_close(run.port[i], run.jax[i], 1e-6, f"{name}: {what} after {steps} substeps")
  np.testing.assert_allclose(run.port[0][0], run.mujoco[0], atol=tol)
  np.testing.assert_allclose(run.port[1][0], run.mujoco[1], atol=10 * tol)


@pytest.mark.parametrize("imp", [1.0, 3.0])
def test_sliding_puck(imp):
  xml = SCENES["puck"].xml.replace('impratio="1"', f'impratio="{imp}"')
  with torch_threads(1):
    run = solver_scene_run("puck", 100, xml=xml, checks=(0, 50))
  _check_run(run, f"puck imp {imp}", 1e-6, 100)


@pytest.mark.parametrize("imp", [1.0, 5.0])
def test_actuated_kicker(imp):
  def ctrl(i):
    t = i * 0.002
    return np.array([0.8 * np.sin(4 * t), -0.5 * np.cos(4 * t)])

  with torch_threads(1):
    run = solver_scene_run("puck", 80, xml=KICKER_XML.format(imp=imp), qvel=(),
                           ctrl_fn=ctrl, checks=(0, 40, 79))
  assert run.ttp.nefc == run.jtp.nefc and run.ttp.dev.con.cone_groups
  _check_run(run, f"kicker imp {imp}", 5e-6, 80)


@pytest.mark.parametrize("cone", [PYR, ELL])
@pytest.mark.parametrize("cd", [4, 6])
def test_spinning_ball_condim(cd, cone):
  name = f"spinner_condim{cd}"
  with torch_threads(1):
    run = solver_scene_run(name, 60, cone=cone, checks=(0, 30))
  rows = cd if cone == ELL else 2 * (cd - 1)
  assert run.ttp.nefc == run.jtp.nefc == rows
  _check_run(run, f"{name} cone {cone}", 1e-6, 60)


def _puck_zone_states(n_worlds=24, seed=0):
  """Puck worlds resting in contact with seeded velocities and warm starts,
  spread so that the cone residual at the starting point falls in each
  zone."""
  mj = solver_scene_model("puck")
  mj.opt.iterations, mj.opt.ls_iterations = 1, 0
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  rng = np.random.default_rng(seed)
  d0 = jphysics.make_data(jtp, jm)
  qpos = np.tile(np.asarray(d0.qpos), (n_worlds, 1))
  qpos[:, 2] = 0.0995
  qvel = rng.normal(0, 1.0, (n_worlds, 6))
  ws = rng.normal(0, 30.0, (n_worlds, 6))
  ws[: n_worlds // 3, 2] = 40.0  # pulled off the floor: top
  ws[n_worlds // 3 : 2 * n_worlds // 3, 2] = -40.0  # pushed in, little slip: bottom
  ws[n_worlds // 3 : 2 * n_worlds // 3, :2] *= 0.01
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n_worlds,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel), qacc_warmstart=jnp.asarray(ws))
  return jtp, jm, ttp, tm, jax_data_arrays(d)


def test_cone_zones_forces_and_hessians_match_jax():
  jtp, jm, ttp, tm, arrays = _puck_zone_states()
  jd = jax.jit(jax.vmap(lambda d: jphysics.forward(jtp, jm, d)))(jax_data_from_arrays(arrays))
  want = jax_data_arrays(jd)
  with torch_threads(1):
    td = tphysics.forward(ttp, tm, to_torch(arrays))
    got = tio.data_to_arrays(td)
    # The zones at the starting point (the warm start or a0, by cost).
    gen = tsolver.GeneralCost(ttp, tm, td)
    x0 = torch.where((gen.total_cost(td.qacc_warmstart) < gen.total_cost(td.qacc_smooth))[:, None],
                     td.qacc_warmstart, td.qacc_smooth)
    g = gen.groups[0]
    _, _, _, top, bottom, _ = gen.zones(g, gen.residual(x0)[:, g.rows])
    act = g.active[:, 0]
    counts = {"top": int((top & act).sum()), "bottom": int((bottom & ~top & act).sum()),
              "middle": int((~top & ~bottom & act).sum())}
  assert min(counts.values()) >= 2, counts
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    assert_close(got[f], want[f], 1e-9, f)


def test_cone_force_and_hessian_are_the_cost_derivatives():
  """f = −∂cost/∂r and B = ∂²cost/∂r² in every zone (central differences of
  the port's own cost and force, 1e-6 relative)."""
  _, _, ttp, tm, arrays = _puck_zone_states(seed=1)
  with torch_threads(1):
    td = tphysics.forward(ttp, tm, to_torch(arrays))
    gen = tsolver.GeneralCost(ttp, tm, td)
    g = gen.groups[0]
    r = gen.residual(td.qacc_warmstart)
    u = r[:, g.rows]
    f, B = gen.cone_force(g, u), gen.cone_hess(g, u)

    def cost(uu):
      rr = r.clone()
      rr[:, g.flat_rows] = uu.flatten(1)
      return gen.cone_cost(rr)

    h = 1e-6
    for k in range(u.shape[-1]):
      e = torch.zeros_like(u)
      e[..., k] = h
      dc = (cost(u + e) - cost(u - e)) / (2 * h)
      assert_close(-dc.numpy(), f[:, 0, k].numpy(), 1e-6, f"force {k}")
      dfk = (gen.cone_force(g, u + e) - gen.cone_force(g, u - e)) / (2 * h)
      assert_close(-dfk[:, 0].numpy(), B[:, 0, :, k].numpy(), 1e-6, f"hessian column {k}")


@pytest.mark.parametrize("cone, name", [(ELL, "puck"), (PYR, "spinner_condim6"),
                                        (ELL, "spinner_condim6")])
def test_contact_forces_match_jax(cone, name):
  with torch_threads(1):
    run = solver_scene_run(name, 2, cone=cone, checks=(0,))
  post = run.stages[0][1]
  want = np.asarray(jax.jit(jax.vmap(lambda d: jcon.contact_forces(run.jtp, run.jm, d)))(
    jax_data_from_arrays(post)))
  got = tcon.contact_forces(run.ttp, run.tm, to_torch(post)).numpy()
  assert_close(got, want, 1e-9, "contact_forces")
  assert np.abs(want[..., 0]).max() > 0


def test_newton_direction_cone_plain_against_a_formed_matrix():
  _, _, ttp, tm, arrays = _puck_zone_states(seed=2)
  with torch_threads(1):
    td = tphysics.forward(ttp, tm, to_torch(arrays))
    gen = tsolver.GeneralCost(ttp, tm, td)
    r = gen.residual(td.qacc_warmstart)
    w, Bc = gen.row_hess(r), gen.cone_blocks(r)
    grad = torch.ones_like(td.qacc)
    x = chol.newton_direction_cone_plain(td.qM, td.efc_J, w, grad, Bc,
                                         ttp.dev.con.cone_kernel_layout).numpy()
  qM, J, wn, Bn = (a.numpy() for a in (td.qM, td.efc_J, w, Bc))
  H = qM + np.einsum("bri,br,brj->bij", J, wn, J)
  for adr, cd, off in ttp.dev.con.cone_kernel_layout.table.numpy():
    Js = J[:, adr : adr + cd]
    H += np.einsum("bri,brs,bsj->bij", Js, Bn[:, off : off + cd * cd].reshape(-1, cd, cd), Js)
  want = np.linalg.solve(H + 1e-10 * np.eye(H.shape[-1]), np.ones_like(x)[..., None])[..., 0]
  assert_close(x, want, 1e-10, "direction")


def test_g1_substep_under_the_elliptic_cone():
  """One G1 velocity-flat substep (cone="elliptic", nefc 1320) from 8
  carried contact-rich states, its forward and its rows.

  In world 6 the safeguard of the fifth Newton iteration chooses between
  candidate steps whose costs tie within rounding, and the two packages
  choose differently: qacc then differs by up to 7.8e-9 of its scale (this
  world alone; 2.9e-9 in the batch of 8), efc_force by 7e-9, and qvel by the
  timestep times qacc's difference, 1.3e-8 of qvel's scale. qvel and
  efc_force are held to COST_TIE_TOL, as tests/test_torch_step.py holds the
  pyramidal solve's efc_force at its cost tie."""
  mj = g1_mj_model()
  mj.opt.cone = ELL
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  assert ttp.nefc == jtp.nefc == 1320
  states = scene("g1").states
  jd = jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))(jax_data_from_arrays(states))
  want = jax_data_arrays(jd)
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.step(ttp, tm, to_torch(states)))
    at_pre = {**want, "qpos": states["qpos"], "qvel": states["qvel"]}
    rows = tio.data_to_arrays(tcon.make_constraint(ttp, tm, to_torch(at_pre)))
  for f in ("efc_J", "efc_D", "efc_aref"):
    assert_close(rows[f], want[f], 1e-9, f)
  for f in ("qpos", "qacc", "qfrc_constraint", "qacc_warmstart"):
    assert_close(got[f], want[f], 1e-8, f)
  for f in ("qvel", "efc_force"):
    assert_close(got[f], want[f], COST_TIE_TOL, f)
  assert (np.abs(want["efc_force"]) > 0).sum() > 0


def test_cone_line_gives_the_forces_and_hessians_along_a_direction():
  """The linesearch's Σ f·v and vᵀ B v along u(α) = r + α v, taken without
  forming the force rows or B, equal the formed ones' in every zone (1e-12
  relative), at several α."""
  _, _, ttp, tm, arrays = _puck_zone_states(seed=3)
  with torch_threads(1):
    td = tphysics.forward(ttp, tm, to_torch(arrays))
    gen = tsolver.GeneralCost(ttp, tm, td)
    g = gen.groups[0]
    r0 = gen.residual(td.qacc_warmstart)[:, g.rows]
    v = torch.randn(r0.shape, generator=torch.Generator().manual_seed(0), dtype=r0.dtype)
    line = gen.cone_line(g, r0, v)
    for a in (0.0, 0.3, 1.0, -2.0):
      alpha = torch.full(r0.shape[:1], a, dtype=r0.dtype)
      u = r0 + a * v
      slope, curv = line(alpha)
      assert_close(slope.numpy(), torch.sum(gen.cone_force(g, u) * v, dim=-1).numpy(), 1e-12,
                   f"f · v at {a}")
      want = torch.einsum("bsi,bsij,bsj->bs", v, gen.cone_hess(g, u), v)
      assert_close(curv.numpy(), want.numpy(), 1e-12, f"vᵀ B v at {a}")
