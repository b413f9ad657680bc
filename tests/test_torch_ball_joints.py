"""Ball joints and bodies with several joints, the port against the JAX
package (float64, CPU) and MuJoCo: the ball's cone-limit row (pos, J, D,
aref), trajectories of the ball-and-hinge chain (implicitfast, Euler and
RK4), the gimbal (three hinges on one body, a slide and a hinge on its
child), every stage of the small humanoid (multi-hinge bodies, ball hips
with limits, floor contacts) and its substeps, the humanoid's
EntityIndexing against the JAX Entity's, and the features put_model still
refuses, each raising NotImplementedError naming itself.

Tolerances (PERF.md §2): 1e-9 per stage, 1e-8 after a substep, 1e-6 over a
rollout, each relative to max(1, max |JAX|).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets.surface_scenes import HUMANOID_XML, SCENES
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import kinematics as tkin
from mjlab_tpu_torch.physics import solver as tsolver
from tests.torch_parity import (
  assert_close,
  one_world,
  surface_data,
  surface_models,
  surface_rollout,
  to_torch,
  torch_threads,
)

STAGE_TOL, STEP_TOL, ROLLOUT_TOL = 1e-9, 1e-8, 1e-6
# The Newton solve of a stage compared in isolation: the same iterations on
# inputs equal to ~1e-15 land within this of each other.
SOLVE_TOL = 1e-8


def test_ball_limit_row_matches_jax_and_mujoco():
  """The JAX test's state: the ball rotated 0.9 rad about a seeded axis,
  past its 40° cone. The row follows the inactive hinge row."""
  mj, (jtp, jm), (ttp, tm) = surface_models("ball_limit")
  mjd = mujoco.MjData(mj)
  rng = np.random.default_rng(1)
  axis = rng.normal(size=3)
  axis /= np.linalg.norm(axis)
  mjd.qpos[:4] = np.concatenate([[np.cos(0.45)], np.sin(0.45) * axis])
  mjd.qpos[4] = 0.2
  mjd.qvel[:] = rng.uniform(-1, 1, 4)
  mujoco.mj_forward(mj, mjd)
  assert list(ttp.limited_ball_joint_ids) == list(jtp.limited_ball_joint_ids) == [0]
  assert tcon.efc_row_types(ttp) == (0, 0, 2, 0) and ttp.nefc == jtp.nefc == 2
  d, td = surface_data("ball_limit", jtp, jm, qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy())
  want = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d)
  with torch_threads(1):
    got = tphysics.forward(ttp, tm, td)
  assert float(got.efc_D[0, 0]) == 0.0  # the hinge's row, inside its range
  for f in ("efc_pos", "efc_J", "efc_D", "efc_aref", "efc_margin"):
    assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f))[None], STAGE_TOL, f)
  assert mjd.nefc == 1
  np.testing.assert_allclose(got.efc_pos[0, 1].item(), mjd.efc_pos[0], atol=1e-10)
  np.testing.assert_allclose(got.efc_J[0, 1].numpy(), mjd.efc_J.reshape(-1, mj.nv)[0],
                             atol=1e-10)
  np.testing.assert_allclose(got.efc_D[0, 1].item(), mjd.efc_D[0], rtol=1e-9)
  np.testing.assert_allclose(got.efc_aref[0, 1].item(), mjd.efc_aref[0], rtol=1e-8)


@pytest.mark.parametrize("integrator", ["implicitfast", "euler", "rk4"])
def test_ball_chain_trajectory(integrator):
  """The chain swung hard into both limits (the JAX test's velocity) under
  each integrator: the port on JAX's trajectory, and both on MuJoCo's.
  The ball meets its cone after ~115 steps; implicitfast runs 140 (the
  JAX test's 300 cut to keep the file fast), Euler 100, RK4 (four forwards
  a step) 30."""
  opt = {"integrator": {"implicitfast": mujoco.mjtIntegrator.mjINT_IMPLICITFAST,
                        "euler": mujoco.mjtIntegrator.mjINT_EULER,
                        "rk4": mujoco.mjtIntegrator.mjINT_RK4}[integrator]}
  steps = {"implicitfast": 140, "euler": 100, "rk4": 30}[integrator]
  with torch_threads(1):
    r = surface_rollout("ball_limit", steps, **opt)
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-7)
  np.testing.assert_allclose(r.port[1][0], r.mujoco[1], atol=1e-6)
  if integrator == "implicitfast":  # the ball at its cone, the limit row active
    q = r.port[0][0]
    assert 2 * np.arctan2(np.linalg.norm(q[1:4]), q[0]) > np.deg2rad(40)


def test_gimbal_trajectory():
  """Three hinges on one body (offset anchors, the third limited) and a
  slide and a hinge on its child: 60 steps against JAX and MuJoCo."""
  with torch_threads(1):
    r = surface_rollout("gimbal", 60)
  assert tuple(r.ttp.body_jntnum[1:]) == (3, 2)
  for i, f in enumerate(("qpos", "qvel")):
    assert_close(r.port[i], r.jax[i], ROLLOUT_TOL, f)
  np.testing.assert_allclose(r.port[0][0], r.mujoco[0], atol=1e-8)
  np.testing.assert_allclose(r.port[1][0], r.mujoco[1], atol=1e-7)


@pytest.fixture(scope="module")
def humanoid():
  """The humanoid after 10 MuJoCo steps from seeded joint velocities and
  controls (both feet on the floor: 6 contacts), as (JAX
  pre-forward Data, its forward, port pre-forward Data, models), at
  SCENE_BUDGET's Newton iterations."""
  mj, (jtp, jm), (ttp, tm) = surface_models("humanoid")
  mjd = mujoco.MjData(mj)
  rng = np.random.default_rng(3)
  mjd.qvel[6:] = rng.normal(0, 0.3, mj.nv - 6)
  mjd.ctrl[:] = rng.uniform(-0.1, 0.1, mj.nu)
  for _ in range(10):
    mujoco.mj_step(mj, mjd)
  d, td = surface_data("humanoid", jtp, jm, qpos=mjd.qpos.copy(), qvel=mjd.qvel.copy())
  d = d.replace(ctrl=jnp.asarray(mjd.ctrl.copy()))
  td = td.replace(ctrl=torch.tensor(mjd.ctrl[None].copy()))
  want = jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d)
  return dict(mj=mj, jtp=jtp, jm=jm, ttp=ttp, tm=tm, d=d, td=td, want=want)


def test_humanoid_topology(humanoid):
  h = humanoid
  ttp, jtp = h["ttp"], h["jtp"]
  assert (ttp.nq, ttp.nv, ttp.nefc, ttp.ncon_max) == (jtp.nq, jtp.nv, jtp.nefc, jtp.ncon_max)
  assert ttp.nv == 27 and len(ttp.limited_ball_joint_ids) == 2
  assert sorted(set(ttp.body_jntnum.tolist())) == [0, 1, 2, 3]
  for f in ("limited_joint_ids", "limited_ball_joint_ids", "friction_dof_ids"):
    assert np.array_equal(getattr(ttp, f), getattr(jtp, f)), f
  assert tcon.efc_row_types(ttp) == jcon.efc_row_types(jtp)


_POSITION = ("xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "geom_xmat", "site_xpos",
             "site_xmat", "xanchor", "xaxis", "subtree_com", "cinert", "cdof", "qM", "qLD",
             "cvel", "cdof_dot", "efc_J", "efc_D", "efc_aref", "efc_pos", "efc_margin")
_VELOCITY = ("qfrc_bias", "qfrc_passive", "qfrc_spring", "qfrc_damper", "actuator_length",
             "actuator_velocity", "actuator_force", "qfrc_actuator", "qfrc_smooth",
             "qacc_smooth")


def test_humanoid_stages(humanoid):
  """Every stage's outputs at 1e-9; the Newton solve, given JAX's solve
  inputs, at SOLVE_TOL."""
  h = humanoid
  want = one_world(h["want"])
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.forward(h["ttp"], h["tm"], h["td"]))
  for f in _POSITION + _VELOCITY:
    assert_close(got[f], want[f], STAGE_TOL, f)
  for f in ("contact.dist", "contact.pos", "contact.frame"):
    active = want["contact.dist"] < want["contact.includemargin"]
    assert_close(got[f][active], want[f][active], STAGE_TOL, f)
  assert active.sum() >= 4
  # The solve alone, from JAX's pre-solve state.
  pre = to_torch({**want, "qacc_warmstart": one_world(h["d"])["qacc_warmstart"]})
  with torch_threads(1):
    solved = tsolver.solve(h["ttp"], h["tm"], pre)
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    assert_close(getattr(solved, f).numpy(), want[f], SOLVE_TOL, f)


def test_humanoid_substeps(humanoid):
  """Three substeps from the same state, each within 1e-8 of JAX's."""
  h = humanoid
  step = jax.jit(lambda dd: jphysics.step(h["jtp"], h["jm"], dd))
  d, td = h["d"], h["td"]
  with torch_threads(1):
    for i in range(3):
      d = step(d)
      td = tphysics.step(h["ttp"], h["tm"], td)
      for f in ("qpos", "qvel"):
        assert_close(getattr(td, f).numpy(), np.asarray(getattr(d, f))[None], STEP_TOL,
                     f"{f} after substep {i}")
  q = td.qpos.numpy()[0]
  assert np.isfinite(q).all() and q[2] > 0.5


def test_humanoid_elliptic_rows_follow_the_ball_limits(humanoid):
  """Under the elliptic cone the contact slots' rows and the cone slots
  start after both limit blocks (hinge and slide, then ball), as the JAX
  package's; one forward's rows at 1e-9 and its qacc at SOLVE_TOL (the
  cone rows' forces of an unconverged 10-iteration solve are not compared:
  the elliptic safeguard's accept test splits ties by rounding)."""
  h = humanoid
  cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  mj, (jtp, jm), (ttp, tm) = surface_models("humanoid", cone=cone)
  for f in ("contact_slot_row_adr",):
    assert np.array_equal(getattr(tcon, f)(ttp, cone), getattr(jcon, f)(jtp, cone)), f
  for got, want in zip(tcon.elliptic_cone_slots(ttp), jcon.elliptic_cone_slots(jtp)):
    assert np.array_equal(got, want)
  ne, nf, nl, _ = tcon.efc_row_types(ttp)
  assert nl == len(ttp.limited_joint_ids) + 2 and tcon.contact_slot_row_adr(ttp, cone)[0] == ne + nf + nl
  d = h["d"]
  _, td = surface_data("humanoid", jtp, jm, qpos=np.asarray(d.qpos), qvel=np.asarray(d.qvel))
  td = td.replace(ctrl=h["td"].ctrl)
  want = one_world(jax.jit(lambda dd: jphysics.forward(jtp, jm, dd))(d))
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.forward(ttp, tm, td))
  for f in ("efc_J", "efc_D", "efc_aref", "efc_pos"):
    assert_close(got[f], want[f], STAGE_TOL, f)
  assert_close(got["qacc"], want["qacc"], SOLVE_TOL, "qacc")


def test_multi_joint_kinematics_is_batched_over_bodies():
  """The two legs' bodies share each level's group: one pass per joint of
  the signature, whatever the number of bodies in it."""
  _, _, (ttp, _) = surface_models("humanoid")
  groups = {g.sig: g for g in ttp.dev.kin.groups}
  legs = [g for g in ttp.dev.kin.groups if g.sig == (3, 3) and len(g.ids) == 2]
  assert legs, groups.keys()
  assert len(legs[0].joints) == 2 and legs[0].joints[0].jnt.shape == (2,)
  assert ttp.dev.kin.ball_q4.shape == (2, 4)


def test_humanoid_entity_indexing_equals_jax():
  """The port's Entity, bound by name to the compiled scene, against the
  JAX Entity's _compute_indexing on the same compile (the humanoid robot
  attached under "robot/", its floor left out). The JAX Entity's keyframe
  gives each joint one qpos, which a ball joint's 4 do not fit, so the
  attach refuses it (ROADMAP Queue C): the test attaches its spec without
  the keyframe."""
  from mjlab_tpu.entity import Entity as JaxEntity
  from mjlab_tpu.entity import EntityCfg as JaxEntityCfg
  from mjlab_tpu_torch.entity import Entity, EntityCfg

  xml = HUMANOID_XML.replace(
    '<geom name="floor" type="plane" size="0 0 1" contype="1" conaffinity="1"/>', "")
  jent = JaxEntity(JaxEntityCfg(spec_fn=lambda: mujoco.MjSpec.from_string(xml)))
  assert len(jent.spec.keys[0].qpos) != 30  # the JAX keyframe: one qpos per joint
  jent.spec.delete(jent.spec.keys[0])
  spec = mujoco.MjSpec()
  spec.attach(jent.spec, prefix="robot/", frame=spec.worldbody.add_frame())
  mj = spec.compile()
  want = jent._compute_indexing(mj)
  got = Entity(EntityCfg(), "robot", mj).indexing
  for f in ("body_ids", "geom_ids", "site_ids", "ctrl_ids", "joint_ids", "joint_q_adr",
            "joint_v_adr", "free_joint_q_adr", "free_joint_v_adr"):
    assert np.array_equal(getattr(got, f), getattr(want, f)), f
  assert got.mocap_id == want.mocap_id is None
  assert len(got.joint_q_adr) == 15 + 2 * 4 and len(got.joint_v_adr) == 15 + 2 * 3


_REFUSED = {
  "PGS with elliptic cone": ("<option", '<option solver="PGS" cone="elliptic"'),
  "noslip post-solver": ("<option", '<option noslip_iterations="2"'),
  "fluidshape": ("<option", '<option density="1.2"'),
  "transmissions other than joint and tendon": (
    "</worldbody>", '</worldbody><actuator><motor site="a"/></actuator>'),
  # A height field on a moving body against the plane: no narrowphase in
  # either package (the JAX package raises too).
  "collision pair of geom types": ("</worldbody>", '<body pos="0 0 2"><freejoint/><geom '
                                   'type="hfield" hfield="hf"/></body></worldbody><asset>'
                                   '<hfield name="hf" nrow="3" ncol="3" size="1 1 0.1 0.1"/>'
                                   '</asset>'),
  "free/ball joint actuators": ("</worldbody>", '</worldbody><actuator><motor '
                                'joint="b"/></actuator>'),
  "ball joint stiffness": ('type="ball"', 'type="ball" stiffness="2"'),
}
_BASE = """
<mujoco><option timestep="0.002"/>
  <worldbody>
    <geom name="g1" type="plane" size="1 1 0.1"/>
    <body pos="0 0 0.5"><joint name="b" type="ball"/>
      <geom name="g2" type="sphere" size="0.1"/><site name="a"/>
      <body pos="0 0 0.3"><joint name="h" type="hinge"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0 0 0.2" contype="0" conaffinity="0"/>
        <site name="b" pos="0 0 0.2"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""


@pytest.mark.parametrize("feature", sorted(_REFUSED))
def test_still_refused_features_raise(feature):
  """Each feature outside the port raises NotImplementedError naming it;
  the base scene (a ball, a hinge, a sphere on a plane) loads."""
  tio.put_model(mujoco.MjModel.from_xml_string(_BASE), dtype=torch.float64, device="cpu")
  old, new = _REFUSED[feature]
  xml = _BASE.replace(old, new, 1)
  if feature == "fluidshape":  # the per-geom ellipsoid model on the ball
    xml = xml.replace('type="sphere" size="0.1"/>', 'type="sphere" size="0.1" fluidshape="ellipsoid"/>')
  m = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match=feature):
    tio.put_model(m, dtype=torch.float64, device="cpu")


# Features the port refused before PR 14, each on the base scene; the port
# now simulates them as the JAX package does.
_LIFTED = {
  "PGS solver": ("<option", '<option solver="PGS"'),
  "fluid forces": ("<option", '<option density="1.2" viscosity="0.3" wind="0.5 0 0"'),
  "spatial tendon": ("</worldbody>", '</worldbody><tendon><spatial stiffness="30" damping="1">'
                     '<site site="a"/><site site="b"/></spatial></tendon>'),
  "activation dynamics": ("</worldbody>", '</worldbody><actuator><general joint="h" '
                          'dyntype="filter" dynprm="0.1" gainprm="2"/></actuator>'),
  "muscle": ("</worldbody>", '</worldbody><actuator><general joint="h" gaintype="muscle" '
             'gainprm="0.75 1.05 -1 200 0.5 1.6 1.5 1.3 1.2"/></actuator>'),
}


@pytest.mark.parametrize("feature", sorted(_LIFTED))
def test_lifted_features_equal_jax(feature):
  """Each feature the port refused until PR 14 loads and steps: 5
  substeps of the base scene with it (the ball swinging, the sphere on the
  plane; ctrl 0.8) equal the JAX package's within 1e-10 relative in qpos,
  qvel and act at every step."""
  old, new = _LIFTED[feature]
  xml = _BASE.replace(old, new, 1)
  if feature == "muscle":
    xml = xml.replace('type="hinge"', 'type="hinge" range="-1 1" limited="true"')
  mj = mujoco.MjModel.from_xml_string(xml)
  mj.opt.integrator = mujoco.mjtIntegrator.mjINT_EULER  # the JAX package's muscle form
  mj.opt.iterations, mj.opt.ls_iterations = 10, 20
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  d = jphysics.make_data(jtp, jm).replace(
    qvel=jnp.asarray(np.r_[0.5, -0.3, 0.2, 1.0][: mj.nv]), ctrl=jnp.full((mj.nu,), 0.8))
  td = to_torch(one_world(d))
  step = jax.jit(lambda dd: jphysics.step(jtp, jm, dd))
  with torch_threads(1):
    for _ in range(5):
      d = step(d)
      td = tphysics.step(ttp, tm, td)
      for f in ("qpos", "qvel", "act"):
        assert_close(getattr(td, f).numpy(), np.asarray(getattr(d, f))[None], 1e-10, f)
