"""Core datatypes of the physics engine (port of mjlab_tpu/physics/types.py).

As in the JAX package, the compiled model is split into
  * `Topology` — static structure, host numpy. Its fields match the JAX
    package's field by field; `dev` adds the device copies of the index
    tensors the step gathers and scatters with (built once by `put_model`).
  * `Option`   — solver options: float tensors plus static Python ints.
  * `Model`    — float parameter tensors, without an env axis.
  * `Data`     — the batched state: every tensor has the env axis in front.

The MuJoCo enum values the port needs are kept here as plain integers
(`mjtJoint`, `mjtGeom`, ...), named as in `mujoco` so that a reader finds
them; tests/test_torch_imports.py checks them against `mujoco`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


# ---------------------------------------------------------------------------
# MuJoCo enum values (mujoco is not installed where the port runs).
# ---------------------------------------------------------------------------


class mjtJoint:
  mjJNT_FREE = 0
  mjJNT_BALL = 1
  mjJNT_SLIDE = 2
  mjJNT_HINGE = 3


class mjtGeom:
  mjGEOM_PLANE = 0
  mjGEOM_HFIELD = 1
  mjGEOM_SPHERE = 2
  mjGEOM_CAPSULE = 3
  mjGEOM_ELLIPSOID = 4
  mjGEOM_CYLINDER = 5
  mjGEOM_BOX = 6
  mjGEOM_MESH = 7


class mjtSensor:
  mjSENS_ACCELEROMETER = 1
  mjSENS_VELOCIMETER = 2
  mjSENS_GYRO = 3
  mjSENS_FRAMEPOS = 26
  mjSENS_FRAMEQUAT = 27
  mjSENS_FRAMEXAXIS = 28
  mjSENS_FRAMEYAXIS = 29
  mjSENS_FRAMEZAXIS = 30
  mjSENS_FRAMELINVEL = 31
  mjSENS_FRAMEANGVEL = 32
  mjSENS_SUBTREEANGMOM = 37


class mjtObj:
  mjOBJ_BODY = 1
  mjOBJ_XBODY = 2
  mjOBJ_GEOM = 5
  mjOBJ_SITE = 6


class mjtEq:
  mjEQ_CONNECT = 0
  mjEQ_WELD = 1
  mjEQ_JOINT = 2
  mjEQ_TENDON = 3


class mjtBias:
  mjBIAS_NONE = 0
  mjBIAS_AFFINE = 1


class mjtGain:
  mjGAIN_FIXED = 0


class mjtDyn:
  mjDYN_NONE = 0


class mjtTrn:
  mjTRN_JOINT = 0
  mjTRN_TENDON = 3


class mjtWrap:
  mjWRAP_JOINT = 1


class mjtIntegrator:
  mjINT_EULER = 0
  mjINT_RK4 = 1
  mjINT_IMPLICIT = 2
  mjINT_IMPLICITFAST = 3


class mjtSolver:
  mjSOL_PGS = 0
  mjSOL_CG = 1
  mjSOL_NEWTON = 2


class mjtCone:
  mjCONE_PYRAMIDAL = 0
  mjCONE_ELLIPTIC = 1


class mjtDisableBit:
  mjDSBL_FILTERPARENT = 1024


# The JAX package's own option enums (Option.integrator / Option.cone).


class Integrator:
  EULER = 0
  IMPLICITFAST = 1
  RK4 = 2


class ConeType:
  PYRAMIDAL = 0
  ELLIPTIC = 1


# ---------------------------------------------------------------------------
# Static topology (host numpy).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class TerrainGroup:
  """Runtime-broadphase collision group: the mobile geoms of one type
  against a pool of static world geoms (a box terrain). A static pair table
  would hold thousands of boxes times every robot geom; instead a hash of
  1 m cells over the terrain's xy extent gives each robot geom its
  candidates each step, which are cut to `ncand` by distance and to `slots`
  deepest contacts. Host arrays, as in the JAX package; compared by
  identity."""

  robot_type: int  # mjtGeom of the mobile geoms
  robot_geoms: np.ndarray  # (R,) geom ids
  robot_rad: np.ndarray  # (R,) bounding radii
  pool_type: int  # mjtGeom of the pool geoms (BOX)
  pool_geoms: np.ndarray  # (P,) geom ids
  pool_priority: int  # the pool's one geom_priority
  cells: np.ndarray  # (ncx, ncy, L) geom ids, -1 padded
  grid_lo: np.ndarray  # (2,) world xy of the grid's corner
  cell_size: float
  ncand: int  # candidate pool geoms kept per robot geom
  slots: int  # contact slots per robot geom
  condim: np.ndarray  # (R,) combined condim per robot geom


@dataclasses.dataclass(frozen=True)
class GeomPair:
  """One candidate collision pair with static contact-slot allocation."""

  geom1: int
  geom2: int
  type1: int
  type2: int
  ncon: int
  condim: int
  pair_id: int = -1


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nsensor: int
  nsensordata: int
  nmocap: int

  body_parentid: np.ndarray
  body_rootid: np.ndarray
  body_weldid: np.ndarray
  body_jntadr: np.ndarray
  body_jntnum: np.ndarray
  body_dofadr: np.ndarray
  body_dofnum: np.ndarray
  body_geomadr: np.ndarray
  body_geomnum: np.ndarray
  body_mocapid: np.ndarray

  jnt_type: np.ndarray
  jnt_qposadr: np.ndarray
  jnt_dofadr: np.ndarray
  jnt_bodyid: np.ndarray
  jnt_limited: np.ndarray
  jnt_actfrclimited: np.ndarray

  dof_bodyid: np.ndarray
  dof_jntid: np.ndarray
  dof_parentid: np.ndarray

  geom_type: np.ndarray
  geom_bodyid: np.ndarray
  geom_condim: np.ndarray
  geom_priority: np.ndarray
  geom_dataid: np.ndarray
  geom_hulls: dict

  body_gravcomp_host: np.ndarray
  has_fluid: bool

  site_bodyid: np.ndarray
  site_type: np.ndarray
  site_size: np.ndarray

  actuator_trntype: np.ndarray
  actuator_trnid: np.ndarray
  trn_qmat: np.ndarray
  trn_vmat: np.ndarray
  ntendon: int
  tendon_qmat: np.ndarray
  tendon_vmat: np.ndarray
  tendon_length0: np.ndarray
  tendon_invweight0: np.ndarray
  tendon_kind: np.ndarray
  tendon_seg_sites: np.ndarray
  tendon_seg_scale: np.ndarray
  tendon_seg_geom: np.ndarray
  tendon_seg_side: np.ndarray
  limited_tendon_ids: np.ndarray
  actuator_dyn_tendon: np.ndarray
  actuator_gaintype: np.ndarray
  actuator_biastype: np.ndarray
  actuator_ctrllimited: np.ndarray
  actuator_forcelimited: np.ndarray
  na: int
  actuator_dyntype: np.ndarray
  actuator_actadr: np.ndarray
  actuator_actlimited: np.ndarray
  actuator_actearly: np.ndarray
  act_actuator: np.ndarray

  sensor_type: np.ndarray
  sensor_datatype: np.ndarray
  sensor_objtype: np.ndarray
  sensor_objid: np.ndarray
  sensor_reftype: np.ndarray
  sensor_refid: np.ndarray
  sensor_adr: np.ndarray
  sensor_dim: np.ndarray

  body_levels: tuple[np.ndarray, ...]
  dof_ancestor_mask: np.ndarray
  body_subtree_mask: np.ndarray
  body_dof_mask: np.ndarray
  limited_joint_ids: np.ndarray
  limited_ball_joint_ids: np.ndarray
  friction_dof_ids: np.ndarray

  eq_type: np.ndarray
  eq_obj1id: np.ndarray
  eq_obj2id: np.ndarray
  eq_objtype: np.ndarray
  eq_active0: np.ndarray
  neq_rows: int

  pairs: tuple[GeomPair, ...]
  terrain_groups: tuple[TerrainGroup, ...]
  ncon_max: int
  nefc: int

  nhfield: int
  hfield_nrow: np.ndarray
  hfield_ncol: np.ndarray
  hfield_adr: np.ndarray

  # A declared divergence (SimulationCfg.capsule_terrain_from_above): the
  # capsule terrain groups' contacts taken from above (collision.
  # _capsule_box_normals). Off by default, as in the JAX package.
  capsule_terrain_from_above: bool = False

  # Device tables: one namespace per building module (kinematics, smooth,
  # collision, constraint), each holding the index and mask tensors its
  # stages gather/scatter with. Built by io.put_model.
  dev: Any = dataclasses.field(default=None, repr=False)


def index_tensor(x, device) -> torch.Tensor:
  """Host indices as an int64 device tensor (for the device tables)."""
  return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def float_tensor(x, dtype, device) -> torch.Tensor:
  """Host numbers or masks as a float device tensor (for the device tables)."""
  return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)


def per_env(leaf: torch.Tensor, ndim: int) -> torch.Tensor:
  """A Model leaf with a leading env axis: the leaf itself where domain
  randomization gave it one, (B, ...), else a (1, ...) view that broadcasts
  over the envs. `ndim` is the leaf's rank without the env axis."""
  return leaf if leaf.dim() > ndim else leaf.unsqueeze(0)


# ---------------------------------------------------------------------------
# Options and model parameters.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Option:
  timestep: torch.Tensor
  gravity: torch.Tensor
  magnetic: torch.Tensor
  impratio: torch.Tensor
  tolerance: torch.Tensor
  ls_tolerance: torch.Tensor
  density: torch.Tensor
  viscosity: torch.Tensor
  wind: torch.Tensor
  # Static: select code paths, never tensors.
  integrator: int = Integrator.IMPLICITFAST
  cone: int = ConeType.PYRAMIDAL
  solver: int = 2
  iterations: int = 10
  ls_iterations: int = 20


OPTION_STATIC = ("integrator", "cone", "solver", "iterations", "ls_iterations")


@dataclasses.dataclass
class Model:
  opt: Option

  qpos0: torch.Tensor
  qpos_spring: torch.Tensor

  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_inertia: torch.Tensor
  body_invweight0: torch.Tensor
  body_subtreemass: torch.Tensor
  body_gravcomp: torch.Tensor

  jnt_axis: torch.Tensor
  jnt_pos: torch.Tensor
  jnt_range: torch.Tensor
  jnt_stiffness: torch.Tensor
  jnt_margin: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor

  dof_armature: torch.Tensor
  dof_damping: torch.Tensor
  dof_frictionloss: torch.Tensor
  dof_invweight0: torch.Tensor
  dof_solref: torch.Tensor
  dof_solimp: torch.Tensor

  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  geom_size: torch.Tensor
  geom_friction: torch.Tensor
  geom_solref: torch.Tensor
  geom_solimp: torch.Tensor
  geom_solmix: torch.Tensor
  geom_margin: torch.Tensor

  pair_friction: torch.Tensor
  pair_solref: torch.Tensor
  pair_solreffriction: torch.Tensor
  pair_solimp: torch.Tensor
  pair_margin: torch.Tensor

  site_pos: torch.Tensor
  site_quat: torch.Tensor

  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_gear: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  actuator_dynprm: torch.Tensor
  actuator_actrange: torch.Tensor
  actuator_lengthrange: torch.Tensor
  actuator_acc0: torch.Tensor

  hfield_data: torch.Tensor
  hfield_size: torch.Tensor

  eq_solref: torch.Tensor
  eq_solimp: torch.Tensor
  eq_data: torch.Tensor

  tendon_range: torch.Tensor
  tendon_margin: torch.Tensor
  tendon_stiffness: torch.Tensor
  tendon_damping: torch.Tensor
  tendon_lengthspring: torch.Tensor
  tendon_solref_lim: torch.Tensor
  tendon_solimp_lim: torch.Tensor


# ---------------------------------------------------------------------------
# Contacts and batched state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Contact:
  """Fixed contact slots (B, C, ...); a slot is active iff dist <
  includemargin. Frame rows: normal (geom1 → geom2), tangent1, tangent2."""

  dist: torch.Tensor
  pos: torch.Tensor
  frame: torch.Tensor
  includemargin: torch.Tensor
  friction: torch.Tensor
  solref: torch.Tensor
  solimp: torch.Tensor
  solreffriction: torch.Tensor


@dataclasses.dataclass
class Data:
  """Batched state: every field has the env axis B in front of the JAX
  package's single-world shape."""

  time: torch.Tensor
  qpos: torch.Tensor
  qvel: torch.Tensor
  act: torch.Tensor
  ctrl: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor

  qacc_warmstart: torch.Tensor

  xanchor: torch.Tensor
  xaxis: torch.Tensor
  xpos: torch.Tensor
  xquat: torch.Tensor
  xmat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor

  subtree_com: torch.Tensor
  cinert: torch.Tensor
  cdof: torch.Tensor
  cvel: torch.Tensor
  cdof_dot: torch.Tensor

  ten_length: torch.Tensor
  ten_velocity: torch.Tensor
  ten_J: torch.Tensor

  qM: torch.Tensor
  qLD: torch.Tensor

  qfrc_bias: torch.Tensor
  qfrc_passive: torch.Tensor
  qfrc_spring: torch.Tensor
  qfrc_damper: torch.Tensor
  actuator_length: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_force: torch.Tensor
  act_dot: torch.Tensor
  qfrc_actuator: torch.Tensor
  qfrc_smooth: torch.Tensor
  qacc_smooth: torch.Tensor

  contact: Contact
  efc_J: torch.Tensor
  efc_D: torch.Tensor
  efc_aref: torch.Tensor
  efc_pos: torch.Tensor
  efc_margin: torch.Tensor
  efc_frictionloss: torch.Tensor
  efc_force: torch.Tensor
  qfrc_constraint: torch.Tensor

  qacc: torch.Tensor

  sensordata: torch.Tensor

  subtree_linvel: torch.Tensor
  subtree_angmom: torch.Tensor

  ncon_dropped: torch.Tensor

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)
