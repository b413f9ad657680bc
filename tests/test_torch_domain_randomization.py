"""Per-env domain randomization in the port: every row of the JAX package's
FIELD_SPECS through the physics, and `randomize_field`'s semantics.

Physics: a small scene with hinge and slide joints, limits, springs,
friction loss, position actuators, sites, a site weld and contacts, at 5
worlds (a count that equals no dimension of the model, so that a per-env
leaf read on the wrong axis fails loudly instead of broadcasting). All 19
fields carry an env axis in both engines; in each case one field differs in
every world (the others are the compiled values). The port's forward is held
against the JAX package's vmapped forward stage by stage (1e-9; 1e-8 for
the solver's outputs and what follows them), and 4 substeps against the
vmapped step (1e-8 after each). Where the JAX package's own result moves by
more under a 1e-13 relative nudge of qpos (a Newton step accepted or
rejected by rounding), the solver's outputs are held to twice that spread,
the rule the repo uses for ill-conditioned solves (tests/torch_parity.py
`check_asimov_env_steps_from_a_carried_state`).

`randomize_field` (the cases of tests/test_domain_randomization.py) runs on
the port's G1 velocity-flat env on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu.envs.mdp.events import FIELD_SPECS as JAX_FIELD_SPECS
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.envs import mdp
from mjlab_tpu_torch.envs.mdp.events import FIELD_SPECS
from mjlab_tpu_torch.managers import SceneEntityCfg
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.sim.sim import PER_ENV_FIELDS
from tests.torch_parity import (
  assert_close,
  jax_data_arrays,
  jax_data_from_arrays,
  to_torch,
  torch_threads,
)

WORLDS = 5
SMOOTH_TOL, SOLVER_TOL = 1e-9, 1e-8
NUDGES = 3

DR_XML = """
<mujoco>
  <option timestep="0.004" iterations="10" ls_iterations="10" integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" priority="1" friction="0.8 0.01 0.001"/>
    <site name="anchor" pos="-0.1 -0.3 0.32" quat="0.95 0.1 0.2 0.2"/>
    <body name="base" pos="0 0 0.45">
      <freejoint/>
      <geom type="capsule" size="0.06" fromto="-0.15 0 0 0.15 0 0" mass="2"/>
      <site name="imu" pos="0.05 0.02 0.03" quat="0.9 0.1 0.3 0"/>
      <body name="link1" pos="0.2 0 0">
        <joint name="j1" type="hinge" axis="0 1 0" range="-0.4 0.4" damping="0.2"
               armature="0.01" stiffness="2" frictionloss="0.05"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.25 0 -0.1" mass="0.6"/>
        <body name="link2" pos="0.25 0 -0.1">
          <joint name="j2" type="hinge" axis="0 0.6 0.8" range="-0.3 0.3" armature="0.02"/>
          <geom type="capsule" size="0.035" fromto="0 0 0 0.2 0 0" mass="0.4" condim="1"/>
          <body name="link3" pos="0.2 0 0">
            <joint name="j3" type="slide" axis="1 0 0" range="-0.05 0.05" damping="1"
                   frictionloss="0.3"/>
            <geom type="sphere" size="0.05" mass="0.3"/>
          </body>
        </body>
      </body>
      <body name="leg" pos="-0.2 0 0">
        <joint name="j4" type="hinge" axis="1 0 0" range="-0.6 0.6" stiffness="1"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0 0 -0.35" mass="0.5"/>
      </body>
    </body>
    <body name="ball" pos="0.3 0.25 0.3">
      <freejoint/>
      <geom type="sphere" size="0.07" mass="0.5" condim="1"/>
    </body>
    <body name="rod" pos="-0.1 -0.3 0.25" euler="0.3 0.2 0">
      <freejoint/>
      <geom type="capsule" size="0.05" fromto="-0.1 0 0 0.1 0 0" mass="0.7"/>
      <site name="grip" pos="0 0 0.05"/>
    </body>
  </worldbody>
  <equality>
    <weld site1="grip" site2="anchor" solref="0.05 1"/>
  </equality>
  <actuator>
    <position joint="j1" kp="40" kv="1.5" ctrlrange="-0.5 0.5"/>
    <position joint="j2" kp="25" kv="1" forcerange="-3 3"/>
    <position joint="j3" kp="100" kv="4"/>
    <position joint="j4" kp="30"/>
  </actuator>
  <sensor>
    <accelerometer site="imu"/>
    <velocimeter site="imu"/>
    <gyro site="imu"/>
    <subtreeangmom body="base"/>
  </sensor>
  <keyframe>
    <key qpos="0 0 0.45 1 0 0 0  0.1 -0.1 0.01 0.2
               0.3 0.25 0.3 1 0 0 0
               -0.1 -0.3 0.25 0.98 0.15 0.1 0"/>
  </keyframe>
</mujoco>
"""

# Stage outputs of forward: those of the smooth stages and the rows at
# SMOOTH_TOL, those of the solver and after it at SOLVER_TOL.
SMOOTH_FIELDS = (
  "xpos", "xquat", "xipos", "ximat", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat",
  "subtree_com", "cinert", "cdof", "cvel", "qM", "qfrc_bias", "qfrc_passive",
  "qfrc_actuator", "actuator_force", "qacc_smooth", "contact.dist", "contact.pos",
  "contact.frame", "efc_J", "efc_D", "efc_aref",
)
SOLVER_FIELDS = ("efc_force", "qacc", "sensordata")
STATE_FIELDS = ("qpos", "qvel")


def _batched(jm, leaves: dict):
  return jm.replace(**{f: jnp.asarray(v) for f, v in leaves.items()})


@functools.lru_cache(maxsize=None)
def dr_scene():
  """The scene in both engines, the JAX package's vmapped step with every
  FIELD_SPECS leaf batched (one compile), the compiled leaves per world,
  and contact-rich states: 40 of those steps from the keyframe with
  perturbed joints and seeded controls (tests/torch_parity.rollout_states'
  recipe)."""
  mj = mujoco.MjModel.from_xml_string(DR_XML)
  dims = {mj.nbody, mj.njnt, mj.nv, mj.nq, mj.nu, mj.ngeom, mj.nsite, mj.neq, 2, 3, 4, 10}
  assert WORLDS not in dims
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  axes = jm.axes(tuple(FIELD_SPECS))
  step = jax.jit(jax.vmap(lambda m, d: jphysics.step(jtp, m, d), in_axes=(axes, 0)))
  base = {f: np.broadcast_to(np.asarray(getattr(jm, f)),
                             (WORLDS,) + np.shape(getattr(jm, f))).copy()
          for f in FIELD_SPECS}
  rng = np.random.default_rng(11)
  qpos = np.tile(mj.key_qpos[0], (WORLDS, 1))
  hinge = mj.jnt_qposadr[mj.jnt_type == mujoco.mjtJoint.mjJNT_HINGE]
  qpos[:, hinge] += rng.normal(0.0, 0.05, (WORLDS, len(hinge)))
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (WORLDS,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(qpos))
  ref = mj.key_qpos[0][mj.jnt_qposadr[mj.actuator_trnid[:, 0]]]
  jmb = _batched(jm, base)
  for _ in range(40):
    d = step(jmb, d.replace(ctrl=jnp.asarray(ref + rng.normal(0.0, 0.3, (WORLDS, mj.nu)))))
  return jm, ttp, tm, jax_data_arrays(d), step, base


def perturbed(field: str, base: np.ndarray, rng) -> np.ndarray:
  """(WORLDS, ...) values of `field`, different in every world: quaternions
  turned and renormalized, offsets moved, masses, inertias, frictions,
  ranges and actuator parameters scaled, armature, damping, stiffness and
  friction loss raised, qpos0 moved."""
  x = np.broadcast_to(base, (WORLDS,) + base.shape).copy()

  def u(lo, hi):
    return rng.uniform(lo, hi, x.shape)

  if field.endswith("quat"):
    x = x + u(-0.15, 0.15)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)
  if field.endswith("pos"):  # body_pos, body_ipos, geom_pos, site_pos
    return x + u(-0.03, 0.03)
  if field == "qpos0":
    return x + u(-0.05, 0.05)
  if field in ("dof_armature", "dof_damping", "jnt_stiffness", "dof_frictionloss"):
    return x + u(0.0, {"dof_armature": 0.05, "dof_damping": 0.8, "jnt_stiffness": 3.0,
                       "dof_frictionloss": 0.2}[field])
  return x * u(0.7, 1.3)


def test_per_env_fields_are_the_jax_field_specs():
  assert sorted(PER_ENV_FIELDS) == sorted(JAX_FIELD_SPECS) == sorted(FIELD_SPECS)
  for name, spec in FIELD_SPECS.items():
    jspec = JAX_FIELD_SPECS[name]
    assert (spec.entity_type, spec.use_address) == (jspec.entity_type, jspec.use_address)
    want = jspec.default_axes
    assert spec.default_axes == (None if want is None else tuple(want)), name


@pytest.mark.parametrize("field", sorted(JAX_FIELD_SPECS))
def test_per_env_field_through_the_physics(field):
  """Four substeps from the same states: the first one's stage outputs
  (its forward at the states), then the state after each."""
  jm, ttp, tm, states, jstep, base = dr_scene()
  rng = np.random.default_rng(sorted(JAX_FIELD_SPECS).index(field))
  leaves = dict(base, **{field: perturbed(field, np.asarray(getattr(jm, field)), rng)})
  assert not np.allclose(leaves[field][0], leaves[field][1])
  jmb = _batched(jm, leaves)
  tmb = dataclasses.replace(tm, **{f: torch.as_tensor(v) for f, v in leaves.items()})
  nudged = [jax_data_from_arrays(dict(states, qpos=states["qpos"] * (
    1 + 1e-13 * rng.normal(size=states["qpos"].shape)))) for _ in range(NUDGES)]

  def solver_tol(want: dict, spread: list, f: str) -> float:
    """SOLVER_TOL, or twice the JAX package's own spread under the nudges
    where that is larger (a Newton step that one engine accepts and the
    other rejects by rounding: the repo's rule for ill-conditioned solves)."""
    scale = max(1.0, float(np.max(np.abs(want[f]))))
    far = max(float(np.max(np.abs(s[f] - want[f]))) for s in spread)
    return max(SOLVER_TOL, 2 * far / scale)

  jd, td = jax_data_from_arrays(states), to_torch(states)
  with torch_threads(1):
    for k in range(4):
      jd, td = jstep(jmb, jd), tphysics.step(ttp, tmb, td)
      nudged = [jstep(jmb, n) for n in nudged]
      want, got = jax_data_arrays(jd), tio.data_to_arrays(td)
      spread = [jax_data_arrays(n) for n in nudged]
      if k == 0:
        for f in SMOOTH_FIELDS:
          assert_close(got[f], want[f], SMOOTH_TOL, f"{field}: {f}")
        for f in SOLVER_FIELDS:
          assert_close(got[f], want[f], solver_tol(want, spread, f), f"{field}: {f}")
      for f in STATE_FIELDS:
        assert_close(got[f], want[f], solver_tol(want, spread, f),
                     f"{field}: substep {k + 1} {f}")


# ---------------------------------------------------------------------------
# randomize_field on the port's G1 env.
# ---------------------------------------------------------------------------

NUM_ENVS = 6


@pytest.fixture(scope="module")
def g1_env():
  from mjlab_tpu_torch.envs import ManagerBasedRlEnv
  from mjlab_tpu_torch.tasks import load_env_cfg

  cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
  cfg.scene.num_envs, cfg.sim.dtype = NUM_ENVS, "float64"
  return ManagerBasedRlEnv(cfg, device="cpu")


def _randomize(env, field, select=None, mask=None, **kw):
  cfg = SceneEntityCfg("robot", **(select or {}))
  cfg.resolve(env.scene)
  env.sim.expand_model_fields((field,))
  env.model = dataclasses.replace(env.model, **{field: getattr(env.sim.model, field)})
  before = getattr(env.model, field).clone()
  mask = torch.ones(NUM_ENVS, dtype=torch.bool) if mask is None else torch.as_tensor(mask)
  mdp.randomize_field(env, mask, field=field, asset_cfg=cfg, **kw)
  return before, getattr(env.model, field)


def test_masked_scale_on_one_body(g1_env):
  env = g1_env
  mask = np.arange(NUM_ENVS) < 3
  before, after = _randomize(env, "body_mass", {"body_names": ("torso_link",)}, mask,
                             ranges=(1.5, 1.5), operation="scale")
  bid = int(env.scene["robot"].indexing.body_ids[env.scene["robot"].find_bodies(
    ("torso_link",))[0][0]])
  assert torch.allclose(after[:3, bid], 1.5 * before[:3, bid], rtol=1e-12)
  assert torch.equal(after[3:, bid], before[3:, bid])
  other = [i for i in range(after.shape[1]) if i != bid]
  assert torch.equal(after[:, other], before[:, other])


def test_add_log_uniform_on_every_dof(g1_env):
  env = g1_env
  before, after = _randomize(env, "dof_armature", {"joint_names": (".*",)},
                             ranges=(0.01, 0.1), distribution="log_uniform", operation="add")
  dofs = torch.as_tensor(env.scene["robot"].indexing.joint_v_adr)
  delta = (after - before)[:, dofs]
  assert delta.min() >= 0.01 and delta.max() <= 0.1 and len(delta.unique()) > 100
  free = [i for i in range(after.shape[1]) if i not in set(dofs.tolist())]
  assert torch.equal(after[:, free], before[:, free])


def test_unbatched_field_raises(g1_env):
  with pytest.raises(RuntimeError, match="not env-batched"):
    mdp.randomize_field(g1_env, torch.ones(NUM_ENVS, dtype=torch.bool), field="site_pos",
                        ranges=(0.9, 1.1), operation="scale")


def test_unknown_field_raises(g1_env):
  with pytest.raises(ValueError, match="Unknown field"):
    mdp.randomize_field(g1_env, torch.ones(NUM_ENVS, dtype=torch.bool), field="geom_size",
                        ranges=(0.9, 1.1))


@pytest.mark.parametrize("kw,axes", [
  (dict(ranges={1: (0.01, 0.02), 2: (0.001, 0.002)}, operation="abs"), [1, 2]),  # dict ranges
  (dict(ranges=(0.5, 0.6), operation="abs", axes=[2]), [2]),  # explicit axes
  (dict(ranges=(0.5, 0.6), operation="abs"), [0]),  # the default axes
  (dict(ranges=(1.0, 0.1), distribution="gaussian", operation="scale"), [0]),  # (mean, std)
])
def test_axes_and_distributions(g1_env, kw, axes):
  env = g1_env
  before, after = _randomize(env, "geom_friction", {"geom_names": (r".*_foot[1-7]_collision",)},
                             **kw)
  geoms = torch.as_tensor(env.scene["robot"].indexing.geom_ids)[
    torch.as_tensor(env.scene["robot"].find_geoms((r".*_foot[1-7]_collision",))[0])]
  changed = (after != before).any(dim=0).any(dim=-1)  # (ngeom,)
  assert set(torch.nonzero(changed)[:, 0].tolist()) == set(geoms.tolist())
  for ax in range(3):
    moved = not torch.equal(after[:, geoms, ax], before[:, geoms, ax])
    assert moved == (ax in axes), (kw, ax)
  if isinstance(kw["ranges"], dict):
    for ax, (lo, hi) in kw["ranges"].items():
      assert after[:, geoms, ax].min() >= lo and after[:, geoms, ax].max() <= hi


# One call per FIELD_SPECS row: (selection, operation, ranges).
ROWS = {
  "dof_armature": ({"joint_names": (".*knee.*",)}, "scale", (0.5, 2.0)),
  "dof_frictionloss": ({"joint_names": (".*ankle.*",)}, "abs", (0.1, 0.3)),
  "dof_damping": ({"joint_names": (".*",)}, "add", (0.0, 0.3)),  # G1's compiled damping is 0
  "jnt_range": ({"joint_names": (".*hip_pitch.*",)}, "scale", (0.9, 1.1)),
  "jnt_stiffness": ({"joint_names": (".*wrist.*",)}, "add", (1.0, 2.0)),
  "body_mass": ({"body_names": ("torso_link",)}, "add", (-5.0, 5.0)),
  "body_ipos": ({"body_names": ("pelvis",)}, "add", (-0.02, 0.02)),
  "body_iquat": ({"body_names": ("pelvis",)}, "add", (-0.05, 0.05)),
  "body_inertia": ({}, "scale", (0.8, 1.2)),
  "body_pos": ({"body_names": (".*elbow.*",)}, "add", (-0.01, 0.01)),
  "body_quat": ({"body_names": (".*elbow.*",)}, "add", (-0.02, 0.02)),
  "geom_friction": ({"geom_names": (r".*_foot[1-7]_collision",)}, "abs", (0.3, 1.2)),
  "geom_pos": ({"geom_names": (r".*_foot[1-7]_collision",)}, "add", (-0.01, 0.01)),
  "geom_quat": ({"geom_names": (r".*_foot[1-7]_collision",)}, "add", (-0.02, 0.02)),
  "site_pos": ({}, "add", (-0.01, 0.01)),
  "site_quat": ({}, "add", (-0.02, 0.02)),
  "qpos0": ({"joint_names": (".*knee.*",)}, "add", (-0.05, 0.05)),
  "actuator_gainprm": ({"actuator_names": (".*",)}, "scale", (0.8, 1.2)),
  "actuator_biasprm": ({"actuator_names": (".*",)}, "scale", (0.8, 1.2)),
}


def _elements(env, field: str, select: dict) -> set[int]:
  robot, spec = env.scene["robot"], FIELD_SPECS[field]
  ix = robot.indexing
  kind = spec.entity_type
  if kind in ("dof", "joint"):
    ids = robot.find_joints(select["joint_names"])[0]
    base = ix.joint_v_adr if kind == "dof" else (ix.joint_q_adr if spec.use_address
                                                 else ix.joint_ids)
  elif kind == "actuator":
    ids, base = robot.find_actuators(select["actuator_names"])[0], ix.ctrl_ids
  else:
    names = select.get(f"{kind}_names")
    base = getattr(ix, f"{kind}_ids")
    find = {"body": robot.find_bodies, "geom": robot.find_geoms, "site": robot.find_sites}
    ids = range(len(base)) if names is None else find[kind](names)[0]
  return {int(base[i]) for i in ids}


@pytest.mark.parametrize("field", sorted(ROWS))
def test_every_field_on_its_elements_only(g1_env, field):
  """Each FIELD_SPECS row through randomize_field on the G1 env: the
  selected elements' randomized axes change in every env, differently
  across envs and inside the range (for add, by at most the range); no
  other element or axis changes."""
  env = g1_env
  select, op, ranges = ROWS[field]
  before, after = _randomize(env, field, select, ranges=ranges, operation=op)
  elems = sorted(_elements(env, field, select))
  spec = FIELD_SPECS[field]
  axes = (slice(None),) if after.dim() == 2 else (
    list(spec.default_axes) if spec.default_axes is not None else list(range(after.shape[-1])))
  sel_b, sel_a = before[:, elems], after[:, elems]
  if after.dim() == 3:
    sel_b, sel_a = sel_b[..., axes], sel_a[..., axes]
  rest = torch.ones(after.shape[1:], dtype=torch.bool)
  if after.dim() == 3:
    rest[np.ix_(elems, axes)] = False
  else:
    rest[elems] = False
  assert torch.equal(after[:, rest], before[:, rest])
  lo, hi = ranges
  value = {"abs": sel_a, "add": sel_a - sel_b, "scale": None}[op]
  if op == "scale":
    nz = sel_b != 0
    value = sel_a[nz] / sel_b[nz]
  assert value.min() >= lo - 1e-12 and value.max() <= hi + 1e-12
  assert not torch.equal(sel_a[1:], sel_a[:1].expand_as(sel_a[1:]))  # differs across envs


def test_the_env_steps_with_every_field_per_env(g1_env):
  env = g1_env
  for field, (select, op, ranges) in ROWS.items():
    _randomize(env, field, select, ranges=ranges, operation=op)
  assert env.sim.batched_fields == set(FIELD_SPECS)
  with torch_threads(1):
    for _ in range(2):
      obs, rew, *_ = env.step(torch.zeros(NUM_ENVS, env.total_action_dim, dtype=env.dtype))
  assert torch.isfinite(rew).all() and torch.isfinite(obs["policy"]).all()


# ---------------------------------------------------------------------------
# What a randomized leaf does not reach, in both packages (ROADMAP Queue C).
# ---------------------------------------------------------------------------


def test_frictionloss_on_a_dof_without_a_friction_row_changes_nothing():
  """Friction-loss rows exist only for the dofs whose compiled friction loss
  is not 0 (the JAX package's put_model allocates no others, and the port
  mirrors it), so a randomized value on another dof moves no force, where
  MuJoCo's own qacc moves."""
  jm, ttp, tm, states, _, base = dr_scene()
  mj = mujoco.MjModel.from_xml_string(DR_XML)
  dof = int(mj.jnt_dofadr[mj.joint("j2").id])
  assert mj.dof_frictionloss[dof] == 0 and mj.dof_frictionloss.max() > 0
  leaf = base["dof_frictionloss"].copy()
  leaf[:, dof] = 2.0
  td = to_torch(states)
  tm0 = dataclasses.replace(tm, **{f: torch.as_tensor(v) for f, v in base.items()})
  tm1 = dataclasses.replace(tm0, dof_frictionloss=torch.as_tensor(leaf))
  q0 = tphysics.forward(ttp, tm0, td).qacc.numpy()
  q1 = tphysics.forward(ttp, tm1, td).qacc.numpy()
  assert np.array_equal(q0, q1)
  d = mujoco.MjData(mj)
  moved = []
  for fl in (0.0, 2.0):
    mj.dof_frictionloss[dof] = fl
    d.qpos[:], d.qvel[:], d.ctrl[:] = states["qpos"][0], states["qvel"][0], states["ctrl"][0]
    mujoco.mj_forward(mj, d)
    moved.append(d.qacc.copy())
  assert np.abs(moved[1] - moved[0]).max() > 0.1


def test_independent_gain_and_bias_scales_move_the_set_point():
  """A position actuator's force is kp_g (ctrl − q) only while its gain
  (actuator_gainprm[0]) and bias (−actuator_biasprm[1]) stay equal; scaled
  by separate draws, as two randomize_field events do, it holds the joint
  at q = ctrl · kp_g / kp_b instead."""
  jm, ttp, tm, states, _, base = dr_scene()
  gain, bias = base["actuator_gainprm"].copy(), base["actuator_biasprm"].copy()
  gain[:, :, 0] *= 1.2
  bias[:, :, 1:3] *= 0.8
  tmb = dataclasses.replace(tm, **{f: torch.as_tensor(v) for f, v in base.items()})
  tmb = dataclasses.replace(tmb, actuator_gainprm=torch.as_tensor(gain),
                            actuator_biasprm=torch.as_tensor(bias))
  td = to_torch(states)
  q = td.qpos[:, ttp.jnt_qposadr[ttp.actuator_trnid[:, 0]]]
  td = td.replace(ctrl=q.clone(), qvel=torch.zeros_like(td.qvel))
  force = tphysics.forward(ttp, tmb, td).actuator_force
  kp = torch.as_tensor(base["actuator_gainprm"][:, :, 0])
  want = torch.clamp((1.2 - 0.8) * kp * q, -3.0, 3.0)  # j2's forcerange
  want[:, [0, 2, 3]] = ((1.2 - 0.8) * kp * q)[:, [0, 2, 3]]
  assert torch.allclose(force, want, atol=1e-12) and force.abs().max() > 0.1
