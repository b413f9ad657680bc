"""The Asimov scenes' physics against the JAX package, float64 on the CPU:
the stages this slice adds — plane–mesh collision (the 4 deepest hull
vertices, ties broken by index as jax.lax.top_k breaks them), the frame
sensors, fixed-tendon length and Jacobian, actuation through the tendon
actuators, the implicitfast matrix with the tendon term — at 1e-9; one
substep at 1e-8; and a 20-substep rollout at 1e-6, for Asimov (foot
meshes) and Asimov-Toe (tendons, capsule feet).

States: 8 contact-rich states of each scene (a JAX rollout from the
keyframe, tests/torch_parity.py), and for the foot meshes a level-foot
state (all joints at 0, the root quaternion at identity, the soles pressed
1 mm into the floor), where the sole's vertices lie within 4e-5 m of one
depth.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import collision as jcoll
from mjlab_tpu.physics import kinematics as jkin
from mjlab_tpu.physics import sensors as jsens
from mjlab_tpu.physics import smooth as jsmooth
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import kinematics as tkin
from mjlab_tpu_torch.physics import sensors as tsens
from mjlab_tpu_torch.physics import smooth as tsmooth
from tests.torch_parity import (
  assert_close,
  jax_data_arrays,
  jax_data_from_arrays,
  jax_step,
  scene,
  to_torch,
)

# The packages export a `forward` function over their module of that name.
jfwd = importlib.import_module("mjlab_tpu.physics.forward")
tfwd = importlib.import_module("mjlab_tpu_torch.physics.forward")

STAGE_TOL = 1e-9
STEP_TOL = 1e-8
ROLLOUT_TOL = 1e-6
NAMES = ("asimov", "asimov_toe")
CONTACT_FIELDS = ("dist", "pos", "frame", "includemargin", "friction", "solref",
                  "solimp", "solreffriction")


def _run_both(name, jfn, tfn, arrays):
  sc = scene(name)
  jd = jax.jit(jax.vmap(lambda d: jfn(sc.jtp, sc.jm, d)))(jax_data_from_arrays(arrays))
  td = tfn(sc.ttp, sc.tm, to_torch(arrays))
  return jax_data_arrays(jd), tio.data_to_arrays(td)


def _level_foot_states() -> dict[str, np.ndarray]:
  """Two worlds of the Asimov scene with every joint at 0 and the root
  quaternion at identity: the soles level and 1 mm deep (world 0), and
  the same raised by 0.5 mm (world 1)."""
  sc = scene("asimov")
  d = jphysics.make_data(sc.jtp, sc.jm)
  q = np.zeros(sc.mj.nq)
  q[3] = 1.0
  kin = jax.jit(lambda d: jkin.kinematics(sc.jtp, sc.jm, d))
  g = sorted(sc.jtp.geom_hulls)[0]
  low = kin(d.replace(qpos=jnp.asarray(q)))
  v = sc.jtp.geom_hulls[g].verts
  zmin = float(np.min(np.asarray(low.geom_xpos[g] + v @ low.geom_xmat[g].T)[:, 2]))
  qs = np.stack([q, q])
  qs[:, 2] = -zmin - 1e-3 + np.array([0.0, 5e-4])
  arrays = jax_data_arrays(jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), d))
  arrays["qpos"] = qs
  return arrays


def test_collision_of_level_feet():
  """Contacts of the level-foot states after kinematics: every slot's
  distance, point, frame and mixed parameters (tests/test_torch_physics.py
  holds the collision stage on the 8 rollout states of both scenes)."""
  def jfn(tp, m, d):
    return jcoll.collision(tp, m, jkin.kinematics(tp, m, d))

  def tfn(tp, m, d):
    return tcoll.collision(tp, m, tkin.kinematics(tp, m, d))

  want, got = _run_both("asimov", jfn, tfn, _level_foot_states())
  for f in CONTACT_FIELDS:
    assert_close(got[f"contact.{f}"], want[f"contact.{f}"], STAGE_TOL, f)
  active = want["contact.dist"] < want["contact.includemargin"]
  assert active[0].all(), "a level sole 1 mm deep puts all 4 vertices of each foot in"


def _box_hull_verts():
  c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], float)
  return c * np.array([0.1, 0.05, 0.02])


@pytest.mark.parametrize("tilt", [0.0, 1e-3])
def test_plane_convex_breaks_ties_as_top_k(tilt):
  """A box resting level on the plane has 4 bottom corners at exactly one
  depth, and padding repeats a vertex at its depth: the port picks the
  same 4 vertices as jax.lax.top_k (the lower index first), and with a
  small tilt the same deepest 4."""
  verts = _box_hull_verts()
  padded = np.concatenate([verts, np.broadcast_to(verts[:1], (4, 3))])  # V 12
  c, s = np.cos(tilt), np.sin(tilt)
  m2 = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
  p2 = np.array([0.3, -0.2, 0.019])
  p1, m1 = np.zeros(3), np.eye(3)
  want = jax.vmap(jcoll._plane_convex)(
    *(jnp.asarray(x)[None] for x in (p1, m1, p2, m2, padded))
  )
  P1, M1, P2, M2 = (torch.as_tensor(x)[None, None] for x in (p1, m1, p2, m2))
  got = tcoll._plane_convex(P1, M1, None, P2, M2, None, verts=torch.as_tensor(padded)[None])
  # A different vertex would move a contact point by centimetres.
  for g, w, what in zip(got, want, ("dist", "pos", "frame")):
    assert_close(g[0].numpy(), np.asarray(w), 1e-12, what)


@pytest.mark.parametrize("name", NAMES)
def test_frame_sensors_and_sensor_stages(name):
  """sensor_pos (frame position and quaternion), sensor_vel (gyro, frame
  linear and angular velocity, subtree angular momentum) and sensor_acc
  (accelerometer) on forward's own inputs."""
  def jfn(tp, m, d):
    d = jfwd.fwd_velocity(tp, m, jfwd.fwd_position(tp, m, d))
    d = jsmooth.fwd_acceleration(tp, m, jsmooth.fwd_actuation(tp, m, d))
    return jsens.sensor_acc(tp, m, d)

  def tfn(tp, m, d):
    d = tfwd.fwd_velocity(tp, m, tfwd.fwd_position(tp, m, d))
    d = tsmooth.fwd_acceleration(tp, m, tsmooth.fwd_actuation(tp, m, d))
    return tsens.sensor_acc(tp, m, d)

  # qacc is the state's own (the solver is held by the step tests).
  want, got = _run_both(name, jfn, tfn, scene(name).states)
  tp = scene(name).ttp
  for s in range(tp.nsensor):
    adr, dim = int(tp.sensor_adr[s]), int(tp.sensor_dim[s])
    assert_close(got["sensordata"][:, adr:adr + dim], want["sensordata"][:, adr:adr + dim],
                 STAGE_TOL, f"{name}: sensor {s} (type {int(tp.sensor_type[s])})")
  assert {26, 27, 31, 32} <= set(tp.sensor_type.tolist())


@pytest.mark.parametrize("name", NAMES)
def test_tendon_and_actuation(name):
  """Tendon length, Jacobian and velocity; passive forces; actuator
  length, velocity and force (the affine bias and forcerange clipping of
  the tendon actuators) and their joint forces; the implicitfast matrix."""
  sc = scene(name)
  arrays = dict(sc.states)
  rng = np.random.default_rng(3)
  # Controls beyond the tendon actuators' ctrlrange (±0.08) and forces past
  # their forcerange (±72 N) exercise both clamps.
  arrays["ctrl"] = sc.ctrl_ref + rng.normal(0.0, 0.3, arrays["ctrl"].shape)

  def jfn(tp, m, d):
    d = jsmooth.tendon(tp, m, jsmooth.com_pos(tp, m, jkin.kinematics(tp, m, d)))
    d = jsmooth.passive(tp, m, jsmooth.com_vel(tp, m, d))
    d = jsmooth.fwd_actuation(tp, m, jsmooth.crb(tp, m, d))
    return d.replace(qLD=jfwd._implicit_matrix(tp, m, d))

  def tfn(tp, m, d):
    d = tsmooth.tendon(tp, m, tsmooth.com_pos(tp, m, tkin.kinematics(tp, m, d)))
    d = tsmooth.passive(tp, m, tsmooth.com_vel(tp, m, d))
    d = tsmooth.fwd_actuation(tp, m, tsmooth.crb(tp, m, d))
    return d.replace(qLD=tfwd._implicit_matrix(tp, m, d))

  want, got = _run_both(name, jfn, tfn, arrays)
  for f in ("ten_length", "ten_J", "ten_velocity", "qfrc_spring", "qfrc_damper",
            "qfrc_passive", "actuator_length", "actuator_velocity", "actuator_force",
            "qfrc_actuator", "qLD"):
    assert_close(got[f], want[f], STAGE_TOL, f"{name}:{f}")
  if name == "asimov_toe":
    force = want["actuator_force"][:, :4]
    assert np.abs(force).max() == 72.0, "the tendon actuators' forcerange clamps"
    assert np.abs(want["ten_length"]).max() > 0


@pytest.mark.parametrize("name", NAMES)
def test_one_substep(name):
  """One physics step from each of the 8 states."""
  sc = scene(name)
  want = jax_data_arrays(jax_step(name)(jax_data_from_arrays(sc.states)))
  got = tio.data_to_arrays(tfwd.step(sc.ttp, sc.tm, to_torch(sc.states)))
  for f in ("qpos", "qvel", "qacc", "sensordata", "actuator_force", "ten_length"):
    assert_close(got[f], want[f], STEP_TOL, f"{name}:{f}")


@pytest.mark.parametrize("name", NAMES)
def test_rollout_20_substeps(name):
  """20 substeps from the keyframe (joints moved by seeded noise) with
  seeded controls fed to both, 4 worlds: the port within 1e-6 of JAX at
  every substep, or within twice the reference's own spread where that is
  larger. The spread is the largest distance from JAX's trajectory of 8
  JAX runs whose starting qpos is moved by 1e-13 (relative, seeded): two
  runs each that far from the reference can be twice as far apart.

  Asimov-Toe is chaotic at this scale: its 1e-4 kg·m² toes on 20 capsule
  contacts turn such a nudge into more than 1e-6 within 20 substeps (the
  test asserts it), and the port's distance follows that spread substep by
  substep; a single substep stays within 1e-8 (test_one_substep)."""
  sc = scene(name)
  n, nudges = 4, 8
  rng = np.random.default_rng(11)
  d0 = jphysics.make_data(sc.jtp, sc.jm)
  qpos = np.tile(sc.mj.key_qpos[0], (n, 1))
  qpos[:, 7:] += rng.normal(0.0, 0.03, (n, sc.mj.nq - 7))
  nudge = np.random.default_rng(100).standard_normal((nudges, n, sc.mj.nq))
  # World block 0 is the reference, blocks 1..8 its nudged copies.
  qpos_all = np.concatenate([qpos[None], qpos * (1 + 1e-13 * nudge)]).reshape(-1, sc.mj.nq)
  jd = jax.tree_util.tree_map(
    lambda x: jnp.broadcast_to(x, (len(qpos_all),) + x.shape), d0
  ).replace(qpos=jnp.asarray(qpos_all))
  td = to_torch({k: v[:n] for k, v in jax_data_arrays(jd).items()})
  jstep = jax_step(name)
  spread_max = 0.0
  for i in range(20):
    ctrl = sc.ctrl_ref + rng.normal(0.0, 0.1, (n, sc.mj.nu))
    jd = jstep(jd.replace(ctrl=jnp.asarray(np.tile(ctrl, (nudges + 1, 1)))))
    td = tfwd.step(sc.ttp, sc.tm, td.replace(ctrl=torch.tensor(ctrl, dtype=torch.float64)))
    runs, got = jax_data_arrays(jd), tio.data_to_arrays(td)
    for f in ("qpos", "qvel", "sensordata"):
      blocks = runs[f].reshape((nudges + 1, n) + runs[f].shape[1:])
      want = blocks[0]
      scale = max(1.0, float(np.abs(want).max()))
      spread = float(np.abs(blocks[1:] - want).max()) / scale
      spread_max = max(spread_max, spread)
      assert_close(got[f], want, max(ROLLOUT_TOL, 2 * spread),
                   f"{name} substep {i}: {f} (reference spread {spread:.1e})")
  active = runs["contact.dist"][:n] < runs["contact.includemargin"][:n]
  assert active.sum() > 0
  if name == "asimov_toe":
    assert spread_max > ROLLOUT_TOL, "the toe scene should spread past 1e-6 by itself"
  else:
    assert spread_max < 0.5 * ROLLOUT_TOL, "the Asimov rollout should be held at 1e-6"


# An Asimov foot strike recorded from a float32 training rollout (env 186
# of 256, substep 27, the port's env at seed 0 with N(0, 1) actions): the
# left sole lands on 3 of its 4 deepest hull vertices with 5.7 rad/s at the
# ankle.
_STRIKE = {
  "qpos": [7.107617378234863, 4.6494526863098145, 0.7303934097290039, 0.13664880394935608,
           -0.16695822775363922, -0.04622777923941612, -0.9753538370132446,
           -0.22574155032634735, 0.07101041078567505, -0.5465346574783325,
           -0.34187912940979004, -0.10115091502666473, -0.03002852201461792,
           0.13906046748161316, 0.09800460189580917, -0.402452677488327,
           0.5856122970581055, 0.24594023823738098, 0.05243667960166931],
  "qvel": [-0.23957987129688263, -0.22026464343070984, 0.10894918441772461,
           -1.4182827472686768, 3.228193759918213, 4.884098052978516, 5.511800765991211,
           -3.407074213027954, -5.733259201049805, 2.5453131198883057, 5.677696704864502,
           3.545041561126709, -3.66848087310791, -1.7448920011520386, -0.7981277704238892,
           -0.3773462772369385, -5.491347312927246, -0.9711411595344543],
  "ctrl": [0.8425366282463074, -0.25438669323921204, -1.4787060022354126,
           -0.002872079610824585, 1.052242398262024, 0.9359539151191711,
           -0.6590282917022705, -0.5659794807434082, 0.11956847459077835,
           0.7869404554367065, -1.106993317604065, -0.049890514463186264],
  "qacc_warmstart": [-36.66948318481445, -21.547304153442383, 9.717511177062988,
                     -203.6502685546875, 455.0727844238281, 45.258399963378906,
                     556.51513671875, -439.23443603515625, -1115.59912109375,
                     14.091376304626465, 178.5637664794922, 299.26568603515625,
                     -1241.97265625, -156.69366455078125, 155.6720733642578,
                     441.52313232421875, -699.887451171875, -77.78459930419922],
}
_STRIKE_FRICTION = {7: 0.3098202347755432, 13: 0.8836554288864136}


def test_newton_at_ten_iterations_leaves_a_foot_strike_unconverged():
  """A fault of the reference that the port mirrors: at the velocity tasks'
  10 Newton iterations the JAX package's solver (an unbracketed 1-D Newton
  linesearch whose non-improving steps are rejected) leaves this foot
  strike far from its optimum, and the implicit integrator turns the
  spurious constraint force into 710 rad/s at the left ankle, where
  `mujoco.mj_step` (also 10 iterations) gives 7.05 rad/s. With 30
  iterations the JAX package converges to 7.18 rad/s. The port agrees with
  the JAX package at both (1e-8): the Asimov tasks' configurations use 30
  (tasks/velocity/config/asimov/env_cfgs.py), where 10 drive training to
  NaN."""
  import mujoco

  from tests.torch_parity import asimov_mj_model

  out = {}
  for iters in (10, 30):
    mj = asimov_mj_model()
    mj.opt.iterations = iters
    for g, mu in _STRIKE_FRICTION.items():
      mj.geom_friction[g, 0] = mu
    jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
    ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
    jd = jphysics.make_data(jtp, jm).replace(
      **{k: jnp.asarray(v) for k, v in _STRIKE.items()}
    )
    jd = jax.tree_util.tree_map(lambda x: x[None], jd)
    want = jax_data_arrays(jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))(jd))
    got = tio.data_to_arrays(tfwd.step(ttp, tm, to_torch(jax_data_arrays(jd))))
    for f in ("qpos", "qvel", "qacc"):
      assert_close(got[f], want[f], STEP_TOL, f"{iters} iterations: {f}")
    out[iters] = np.abs(want["qvel"][0]).max()
    if iters == 10:
      d = mujoco.MjData(mj)
      for k, v in _STRIKE.items():
        getattr(d, k)[:] = v
      mujoco.mj_step(mj, d)
      out["mujoco"] = np.abs(d.qvel).max()
  assert out[10] > 100 * out["mujoco"], out
  assert abs(out[30] - out["mujoco"]) < 0.05 * out["mujoco"], out
