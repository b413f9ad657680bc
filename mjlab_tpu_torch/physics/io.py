"""Host-side conversion: compiled MuJoCo model → (Topology, Model), make_data
(port of mjlab_tpu/physics/io.py).

`put_model` takes any object with `mujoco.MjModel`'s attribute names: a live
MjModel (the tests), or the namespace `assets.load_model_npz` returns (where
`mujoco` is not installed). It never imports `mujoco`.

The port covers the features of the G1, Go1 and Asimov velocity scenes,
flat and rough: analytic plane/sphere/capsule/box pairs, plane–mesh (convex
hull) pairs, the convex pairs of the hull SAT (box–box, sphere–mesh,
capsule–mesh, box–mesh, mesh–mesh; a cylinder or an ellipsoid collides as
a tessellated mesh hull where no analytic pair exists), the box-terrain
pool for sphere, capsule, box and mesh geoms (a runtime broadphase,
`TerrainGroup`), fixed tendons and tendon transmission, and the IMU, frame
and subtree sensors; and the solver surface: equality constraints
(connect and weld on bodies or sites, joint, tendon), dof friction loss,
limited tendons, contacts of condim 1/3/4/6 under the pyramidal or the
elliptic cone, the Newton and CG solvers, and the implicitfast, Euler and
RK4 integrators. Everything else the JAX package supports (PGS, ball
joints, multi-joint bodies, spatial tendons, explicit pairs, muscles and
activation dynamics, fluid, gravity compensation, mocap, noslip, height
fields, the other sensors) is refused here with `NotImplementedError`
naming the feature, never simulated wrong.

A mesh geom's hull is built from its hull vertices (`_hull_vertices`): a
live MjModel gives them through the qhull graph MuJoCo stores; the npz
namespace carries them as `geom_hull_vert` / `geom_hull_vertadr` /
`geom_hull_vertnum` (what `assets.model_arrays` writes instead of the mesh
arrays). A cylinder's or an ellipsoid's hull is tessellated from its size
(`_primitive_hull_vertices`).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.physics.types import (
  OPTION_STATIC,
  ConeType,
  Contact,
  Data,
  GeomPair,
  Integrator,
  Model,
  Option,
  TerrainGroup,
  Topology,
  mjtBias,
  mjtCone,
  mjtDisableBit,
  mjtDyn,
  mjtEq,
  mjtGain,
  mjtGeom,
  mjtIntegrator,
  mjtJoint,
  mjtObj,
  mjtSensor,
  mjtSolver,
  mjtTrn,
  mjtWrap,
)
from mjlab_tpu_torch.physics.convex import _fibonacci_directions, build_hull

_G = mjtGeom

# Rounded primitives that collide as convex hulls through the SAT where no
# analytic pair exists (plane pairs keep their analytic narrowphase in the
# JAX package, which the port refuses: see _NOT_PORTED_PAIRS).
_HULL_APPROX_TYPES = (_G.mjGEOM_CYLINDER, _G.mjGEOM_ELLIPSOID)
_CYLINDER_SECTORS = 16
_ELLIPSOID_DIRS = 42


def _effective_type(t: int) -> int:
  """Collision-dispatch type: cylinders and ellipsoids collide as mesh hulls."""
  return int(_G.mjGEOM_MESH) if int(t) in _HULL_APPROX_TYPES else int(t)


# Contact slots per (type1, type2) pair, type1 <= type2: the pairs the
# port's collision.py implements, analytic and convex (the JAX package's
# counts).
_PAIR_NCON: dict[tuple[int, int], int] = {
  (_G.mjGEOM_PLANE, _G.mjGEOM_SPHERE): 1,
  (_G.mjGEOM_PLANE, _G.mjGEOM_CAPSULE): 2,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_SPHERE): 1,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_CAPSULE): 1,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_CAPSULE): 1,
  (_G.mjGEOM_PLANE, _G.mjGEOM_MESH): 4,
  (_G.mjGEOM_PLANE, _G.mjGEOM_BOX): 4,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_BOX): 1,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_BOX): 2,
  (_G.mjGEOM_BOX, _G.mjGEOM_BOX): 4,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_MESH): 1,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_MESH): 2,
  (_G.mjGEOM_BOX, _G.mjGEOM_MESH): 4,
  (_G.mjGEOM_MESH, _G.mjGEOM_MESH): 4,
}

# The JAX package's pairs that the port lacks: the analytic plane–cylinder
# and plane–ellipsoid, and the height fields. A pair of these raw types is
# refused, never routed through a hull, since the JAX package would not
# route it so.
_NOT_PORTED_PAIRS = {
  (_G.mjGEOM_PLANE, _G.mjGEOM_CYLINDER), (_G.mjGEOM_PLANE, _G.mjGEOM_ELLIPSOID),
  (_G.mjGEOM_HFIELD, _G.mjGEOM_SPHERE), (_G.mjGEOM_HFIELD, _G.mjGEOM_CAPSULE),
  (_G.mjGEOM_HFIELD, _G.mjGEOM_BOX), (_G.mjGEOM_HFIELD, _G.mjGEOM_MESH),
}

# Static world boxes are pooled into a runtime broadphase (TerrainGroup)
# when there are more than TERRAIN_POOL_MIN of them: a static pair table of
# a generated terrain's thousands of boxes times every robot geom would
# explode. The JAX package's constants, and its reasons for them.
TERRAIN_POOL_MIN = 64
TERRAIN_CANDIDATES = 4  # candidate terrain geoms kept per robot geom
TERRAIN_SLOTS = 6  # contact slots per robot geom: a geom on a tile seam has
# up to ~9 equal-depth corners across the adjacent tiles; 4 slots let the
# selected set flicker with micro-tilt, 6 cover the tie set
_TERRAIN_CELL_SIZE = 1.0  # broadphase hash cell (m)
_TERRAIN_CELL_MARGIN = 0.6  # AABB growth when binning (> the largest robot geom radius)
# Mobile geom types (after _effective_type) with a narrowphase against the
# box pool: sphere–box and capsule–box, and the SAT for boxes and hulls.
_TERRAIN_ROBOT_TYPES = (_G.mjGEOM_SPHERE, _G.mjGEOM_CAPSULE, _G.mjGEOM_BOX, _G.mjGEOM_MESH)

_SUPPORTED_SENSORS = (
  mjtSensor.mjSENS_ACCELEROMETER,
  mjtSensor.mjSENS_VELOCIMETER,
  mjtSensor.mjSENS_GYRO,
  mjtSensor.mjSENS_FRAMEPOS,
  mjtSensor.mjSENS_FRAMEQUAT,
  mjtSensor.mjSENS_FRAMEXAXIS,
  mjtSensor.mjSENS_FRAMEYAXIS,
  mjtSensor.mjSENS_FRAMEZAXIS,
  mjtSensor.mjSENS_FRAMELINVEL,
  mjtSensor.mjSENS_FRAMEANGVEL,
  mjtSensor.mjSENS_SUBTREEANGMOM,
)


def _name(m, adr: np.ndarray, i: int) -> str:
  """Object name from MjModel.names (mj_id2name without mujoco)."""
  names = bytes(m.names)
  start = int(adr[i])
  return names[start : names.index(b"\0", start)].decode() or str(i)


# Rows per active equality constraint, by mjtEq type (the JAX package's
# _EQ_ROWS); connect and weld may name bodies or sites.
_EQ_ROWS = {mjtEq.mjEQ_CONNECT: 3, mjtEq.mjEQ_WELD: 6, mjtEq.mjEQ_JOINT: 1,
            mjtEq.mjEQ_TENDON: 1}


def _reject_unsupported(m) -> None:
  """Refuse every feature outside the port's slice, naming it."""
  opt = m.opt

  def no(feature: str):
    raise NotImplementedError(f"{feature} is not supported by mjlab_tpu_torch")

  if int(opt.integrator) not in (
    mjtIntegrator.mjINT_EULER, mjtIntegrator.mjINT_RK4,
    mjtIntegrator.mjINT_IMPLICIT, mjtIntegrator.mjINT_IMPLICITFAST,
  ):
    no(f"integrator {int(opt.integrator)}")
  if int(opt.solver) == mjtSolver.mjSOL_PGS:
    if int(opt.cone) == mjtCone.mjCONE_ELLIPTIC:
      no("PGS with elliptic cone (use solver='newton'/'cg' or cone='pyramidal')")
    no("PGS solver (use solver='newton' or 'cg')")
  if int(opt.noslip_iterations) > 0:
    no("noslip post-solver")
  if float(opt.viscosity) or float(opt.density) or np.any(opt.wind):
    no("fluid forces (density/viscosity/wind)")
  for t in range(m.ntendon):
    if _is_spatial_tendon(m, t):
      no(f"spatial tendon {_name(m, m.name_tendonadr, t)}")
  for e in range(m.neq):
    if not m.eq_active0[e]:
      continue
    et = int(m.eq_type[e])
    if et not in _EQ_ROWS:
      no(f"equality constraint type {et} (connect, weld, joint and tendon only)")
    if et in (mjtEq.mjEQ_CONNECT, mjtEq.mjEQ_WELD) and int(m.eq_objtype[e]) not in (
      mjtObj.mjOBJ_BODY, mjtObj.mjOBJ_SITE
    ):
      no("connect/weld equality on objects other than bodies and sites")
  if m.nmocap:
    no("mocap bodies")
  if m.npair:
    no("explicit <pair> elements")
  if np.any(m.body_gravcomp > 0):
    no("gravity compensation")
  if m.na or np.any(m.actuator_dyntype != mjtDyn.mjDYN_NONE):
    no("actuator activation dynamics")
  if np.any(m.actuator_gaintype != mjtGain.mjGAIN_FIXED):
    no("actuator gain types other than fixed (muscle)")
  if np.any(
    ~np.isin(m.actuator_biastype, [mjtBias.mjBIAS_NONE, mjtBias.mjBIAS_AFFINE])
  ):
    no("actuator bias types other than none/affine (muscle)")
  if np.any(~np.isin(m.actuator_trntype, [mjtTrn.mjTRN_JOINT, mjtTrn.mjTRN_TENDON])):
    no("actuator transmissions other than joint and tendon")
  if np.any(m.jnt_type == mjtJoint.mjJNT_BALL):
    no("ball joints (and their limits)")
  if np.any(m.body_jntnum > 1):
    no("bodies with more than one joint")
  if np.any(~np.isin(m.geom_condim, [1, 3, 4, 6])):
    no("contact condim other than 1, 3, 4 and 6")
  for s in m.sensor_type:
    if int(s) not in _SUPPORTED_SENSORS:
      no(f"sensor type {int(s)}")
  if np.any(m.sensor_reftype != 0):
    no("sensors with a reference frame (reftype)")
  # Height-field pairs, plane–cylinder and plane–ellipsoid, and geom types
  # with no narrowphase against a terrain pool are refused by
  # _candidate_pairs.


def _is_spatial_tendon(m, t: int) -> bool:
  adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
  return any(int(m.wrap_type[w]) != mjtWrap.mjWRAP_JOINT for w in range(adr, adr + num))


def _hull_vertices(m, geom_id: int) -> np.ndarray:
  """Convex-hull vertices of a mesh geom, in the geom frame. A live MjModel
  gives them through its qhull graph (mesh_graph: [numvert, numface,
  vert_edgeadr, vert_globalid, ...]), or as all mesh vertices where no
  graph is stored; the npz namespace carries them per geom."""
  if hasattr(m, "geom_hull_vertadr"):
    adr, num = int(m.geom_hull_vertadr[geom_id]), int(m.geom_hull_vertnum[geom_id])
    if adr < 0:
      raise ValueError(f"geom {geom_id} has no hull vertices in the npz")
    return np.asarray(m.geom_hull_vert[adr : adr + num], dtype=np.float64)
  mesh_id = int(m.geom_dataid[geom_id])
  vadr, vnum = int(m.mesh_vertadr[mesh_id]), int(m.mesh_vertnum[mesh_id])
  verts = m.mesh_vert[vadr : vadr + vnum]
  gadr = int(m.mesh_graphadr[mesh_id])
  if gadr >= 0:
    graph = m.mesh_graph[gadr:]
    numvert = int(graph[0])
    verts = verts[graph[2 + numvert : 2 + 2 * numvert]]
  return np.asarray(verts, dtype=np.float64)


def _primitive_hull_vertices(t: int, size: np.ndarray) -> np.ndarray:
  """Tessellated hull vertices of a rounded primitive, in the geom frame: a
  cylinder's two rings of _CYLINDER_SECTORS at z = ±half-length, an
  ellipsoid's _ELLIPSOID_DIRS Fibonacci directions scaled by its semi-axes
  (the JAX package's)."""
  if t == _G.mjGEOM_CYLINDER:
    r, h = float(size[0]), float(size[1])
    th = np.linspace(0, 2 * np.pi, _CYLINDER_SECTORS, endpoint=False)
    ring = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    top = np.concatenate([ring, np.full((len(th), 1), h)], axis=-1)
    bot = np.concatenate([ring, np.full((len(th), 1), -h)], axis=-1)
    return np.concatenate([top, bot], axis=0)
  if t == _G.mjGEOM_ELLIPSOID:
    return _fibonacci_directions(_ELLIPSOID_DIRS) * np.asarray(size, dtype=np.float64)
  raise NotImplementedError(f"no hull approximation for geom type {t}")


def hull_geoms(m, pairs=None, groups=None) -> list[int]:
  """The geoms that collide through a convex hull, ascending: those of
  dispatch type mesh in the collision pairs and the terrain groups'
  (`pairs` and `groups`, default the model's candidate pairs)."""
  if pairs is None:
    pairs, groups = _candidate_pairs(m)
  return sorted(
    {p.geom1 for p in pairs if p.type1 == _G.mjGEOM_MESH}
    | {p.geom2 for p in pairs if p.type2 == _G.mjGEOM_MESH}
    | {int(g) for tg in groups if tg.robot_type == _G.mjGEOM_MESH for g in tg.robot_geoms}
  )


def _pair_key(m, ga: int, gb: int):
  """Dispatch key and geom order of a candidate pair: the raw types where
  the pair exists, else the types with cylinders and ellipsoids as hulls
  (the JAX package's fallback); None where the port has no narrowphase."""
  t1, t2 = int(m.geom_type[ga]), int(m.geom_type[gb])
  if t1 > t2:
    ga, gb, t1, t2 = gb, ga, t2, t1
  if (t1, t2) in _PAIR_NCON:
    return (t1, t2), ga, gb
  if (t1, t2) in _NOT_PORTED_PAIRS:
    return None, ga, gb
  e1, e2 = _effective_type(t1), _effective_type(t2)
  if e1 > e2:
    ga, gb, e1, e2 = gb, ga, e2, e1
  return ((e1, e2) if (e1, e2) in _PAIR_NCON else None), ga, gb


def _combined_condim(m, ga: int, gb: int) -> int:
  """mj_contactParam condim: higher-priority geom wins, else max."""
  p1, p2 = int(m.geom_priority[ga]), int(m.geom_priority[gb])
  if p1 != p2:
    return int(m.geom_condim[ga if p1 > p2 else gb])
  return max(int(m.geom_condim[ga]), int(m.geom_condim[gb]))


def _quat2mat(q: np.ndarray) -> np.ndarray:
  """mju_quat2Mat: (3, 3) rotation of a unit quaternion (w, x, y, z), the
  identity exactly for the identity quaternion."""
  w, x, y, z = (float(v) for v in q)
  if w == 1 and x == 0 and y == 0 and z == 0:
    return np.eye(3)
  q00, q01, q02, q03 = w * w, w * x, w * y, w * z
  q11, q12, q13 = x * x, x * y, x * z
  q22, q23, q33 = y * y, y * z, z * z
  return np.asarray([
    [q00 + q11 - q22 - q33, 2 * (q12 - q03), 2 * (q13 + q02)],
    [2 * (q12 + q03), q00 - q11 + q22 - q33, 2 * (q23 - q01)],
    [2 * (q13 - q02), 2 * (q23 + q01), q00 - q11 - q22 + q33],
  ])


def _geom_bounding_radius(m, g: int) -> float:
  """Bounding-sphere radius of a geom about its frame origin."""
  t = int(m.geom_type[g])
  s = m.geom_size[g]
  if t == _G.mjGEOM_SPHERE:
    return float(s[0])
  if t == _G.mjGEOM_CAPSULE:
    return float(s[0] + s[1])
  if t == _G.mjGEOM_CYLINDER:
    return float(np.hypot(s[0], s[1]))
  if t == _G.mjGEOM_MESH:
    return float(np.max(np.linalg.norm(_hull_vertices(m, g), axis=-1)))
  return float(np.linalg.norm(s))  # box, ellipsoid and the rest


def _geom_world_aabb(m, g: int) -> tuple[np.ndarray, np.ndarray]:
  """World AABB of a static (world-welded) geom from its model pose."""
  pos = m.geom_pos[g]
  if int(m.geom_type[g]) == _G.mjGEOM_BOX:
    ext = np.abs(_quat2mat(m.geom_quat[g])) @ m.geom_size[g]
  else:
    ext = np.full(3, _geom_bounding_radius(m, g))
  return pos - ext, pos + ext


def _build_terrain_groups(
  m, pool: list[int], mobile_by_type: dict[int, list[int]]
) -> list[TerrainGroup]:
  """A spatial hash of 1 m cells over the pool (each cell lists the pool
  geoms whose AABB, grown by the margin, reaches it) and one group per
  mobile geom type."""
  lo = np.full(2, np.inf)
  hi = np.full(2, -np.inf)
  aabbs = []
  for g in pool:
    a, b = _geom_world_aabb(m, g)
    aabbs.append((a, b))
    lo = np.minimum(lo, a[:2])
    hi = np.maximum(hi, b[:2])
  cs, mg = _TERRAIN_CELL_SIZE, _TERRAIN_CELL_MARGIN
  ncx = max(1, int(np.ceil((hi[0] - lo[0]) / cs)))
  ncy = max(1, int(np.ceil((hi[1] - lo[1]) / cs)))

  def cell(v: float, lo_: float, n: int) -> int:
    return int(np.clip(np.floor((v - lo_) / cs), 0, n - 1))

  buckets: list[list[list[int]]] = [[[] for _ in range(ncy)] for _ in range(ncx)]
  for g, (a, b) in zip(pool, aabbs):
    for ix in range(cell(a[0] - mg, lo[0], ncx), cell(b[0] + mg, lo[0], ncx) + 1):
      for iy in range(cell(a[1] - mg, lo[1], ncy), cell(b[1] + mg, lo[1], ncy) + 1):
        buckets[ix][iy].append(g)
  L = max(1, max(len(c) for col in buckets for c in col))
  cells = np.full((ncx, ncy, L), -1, dtype=np.int32)
  for ix in range(ncx):
    for iy in range(ncy):
      ids = buckets[ix][iy]
      cells[ix, iy, : len(ids)] = ids

  if len({int(m.geom_priority[g]) for g in pool}) != 1:
    raise NotImplementedError("terrain pool geoms must share one priority")
  groups = []
  for rtype in sorted(mobile_by_type):
    geoms = sorted(mobile_by_type[rtype])
    groups.append(
      TerrainGroup(
        robot_type=rtype,
        robot_geoms=np.asarray(geoms, dtype=np.int32),
        robot_rad=np.asarray([_geom_bounding_radius(m, g) for g in geoms]),
        pool_type=_G.mjGEOM_BOX,
        pool_geoms=np.asarray(pool, dtype=np.int32),
        pool_priority=int(m.geom_priority[pool[0]]),
        cells=cells,
        grid_lo=lo,
        cell_size=cs,
        ncand=TERRAIN_CANDIDATES,
        slots=TERRAIN_SLOTS,
        condim=np.asarray(
          [_combined_condim(m, g, pool[0]) for g in geoms], dtype=np.int32
        ),
      )
    )
  return groups


def _candidate_pairs(m) -> tuple[list[GeomPair], list[TerrainGroup]]:
  """Collision pairs with MuJoCo's body-level filtering (same-body/weld,
  parent-child unless disabled, <exclude>, contype/conaffinity), sorted by
  type pair so each narrowphase group is contiguous; and the terrain groups
  of a box pool (more than TERRAIN_POOL_MIN static world boxes), whose
  pairs leave the static table."""
  excluded = set()
  for i in range(m.nexclude):
    sig = int(m.exclude_signature[i])
    excluded.add((sig >> 16, sig & 0xFFFF))
  filterparent = not (int(m.opt.disableflags) & mjtDisableBit.mjDSBL_FILTERPARENT)

  def compatible(g1: int, g2: int) -> bool:
    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    w1, w2 = int(m.body_weldid[b1]), int(m.body_weldid[b2])
    if w1 == w2:
      return False
    pw1 = int(m.body_weldid[m.body_parentid[w1]])
    pw2 = int(m.body_weldid[m.body_parentid[w2]])
    if filterparent and w1 != 0 and w2 != 0 and (w1 == pw2 or w2 == pw1):
      return False
    if (b1, b2) in excluded or (b2, b1) in excluded:
      return False
    t1, t2 = int(m.geom_contype[g1]), int(m.geom_contype[g2])
    a1, a2 = int(m.geom_conaffinity[g1]), int(m.geom_conaffinity[g2])
    return bool((t1 & a2) or (t2 & a1))

  def world(g: int) -> bool:
    return int(m.body_weldid[m.geom_bodyid[g]]) == 0

  world_boxes = [
    g for g in range(m.ngeom) if world(g) and int(m.geom_type[g]) == _G.mjGEOM_BOX
  ]
  pool: set[int] = set()
  mobile_by_type: dict[int, list[int]] = {}
  if len(world_boxes) > TERRAIN_POOL_MIN:
    pool = set(world_boxes)
    # A mobile geom joins a group iff it is compatible with the whole pool
    # (probed at its first and last box; mixed compatibility raises).
    for g in range(m.ngeom):
      if world(g):
        continue
      compat = [compatible(g, p) for p in (world_boxes[0], world_boxes[-1])]
      if not any(compat):
        continue
      if not all(compat):
        raise NotImplementedError(
          "geom has mixed collision compatibility with the terrain pool"
        )
      t = _effective_type(int(m.geom_type[g]))
      if t not in _TERRAIN_ROBOT_TYPES:
        raise NotImplementedError(
          f"terrain collision of geom {_name(m, m.name_geomadr, g)} (geom type {t}) "
          "against the box pool is not supported by mjlab_tpu_torch"
        )
      mobile_by_type.setdefault(t, []).append(g)

  rest = [g for g in range(m.ngeom) if g not in pool]
  pairs: list[GeomPair] = []
  for i, g1 in enumerate(rest):
    for g2 in rest[i + 1 :]:
      if not compatible(g1, g2):
        continue
      key, ga, gb = _pair_key(m, g1, g2)
      if key is None:
        names = [_name(m, m.name_geomadr, g) for g in (ga, gb)]
        raise NotImplementedError(
          f"collision pair of geom types "
          f"{(int(m.geom_type[ga]), int(m.geom_type[gb]))} between geoms "
          f"{names} is not supported by mjlab_tpu_torch"
        )
      pairs.append(
        GeomPair(
          geom1=ga, geom2=gb, type1=key[0], type2=key[1],
          ncon=_PAIR_NCON[key], condim=_combined_condim(m, ga, gb),
        )
      )
  pairs.sort(key=lambda p: (p.type1, p.type2))
  groups = _build_terrain_groups(m, sorted(pool), mobile_by_type) if pool else []
  return pairs, groups


def _transmission_matrices(m) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Static (nu, nq) / (nu, nv) transmission matrices: one-hot rows for a
  joint, the tendon's joint coefficients for a fixed tendon (its length is
  linear in qpos, so its moment is constant). No actuator rides a spatial
  tendon (refused), so the dynamic map is all -1."""
  qmat = np.zeros((m.nu, m.nq))
  vmat = np.zeros((m.nu, m.nv))
  for u in range(m.nu):
    if int(m.actuator_trntype[u]) == mjtTrn.mjTRN_JOINT:
      j = int(m.actuator_trnid[u, 0])
      if int(m.jnt_type[j]) not in (mjtJoint.mjJNT_HINGE, mjtJoint.mjJNT_SLIDE):
        raise NotImplementedError("free/ball joint actuators")
      qmat[u, m.jnt_qposadr[j]] = 1.0
      vmat[u, m.jnt_dofadr[j]] = 1.0
    else:
      t = int(m.actuator_trnid[u, 0])
      qmat[u], vmat[u] = _fixed_tendon_rows(m, t)
  return qmat, vmat, np.full(m.nu, -1, dtype=np.int32)


def _fixed_tendon_rows(m, t: int) -> tuple[np.ndarray, np.ndarray]:
  """A fixed tendon's (nq,) and (nv,) joint-coefficient rows."""
  qrow, vrow = np.zeros(m.nq), np.zeros(m.nv)
  adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
  for w in range(adr, adr + num):
    j = int(m.wrap_objid[w])
    coef = float(m.wrap_prm[w])
    qrow[m.jnt_qposadr[j]] += coef
    vrow[m.jnt_dofadr[j]] += coef
  return qrow, vrow


def _tendon_matrices(m) -> tuple[np.ndarray, np.ndarray]:
  """Per-tendon (ntendon, nq) / (ntendon, nv) linear maps (every tendon is
  fixed: spatial ones are refused)."""
  rows = [_fixed_tendon_rows(m, t) for t in range(m.ntendon)]
  qmat = np.asarray([q for q, _ in rows]).reshape(m.ntendon, m.nq)
  vmat = np.asarray([v for _, v in rows]).reshape(m.ntendon, m.nv)
  return qmat, vmat


def _dof_ancestor_mask(m) -> np.ndarray:
  """mask[i, j] = 1 iff dof j is an ancestor of dof i (or j == i)."""
  mask = np.zeros((m.nv, m.nv), dtype=bool)
  for i in range(m.nv):
    j = i
    while j >= 0:
      mask[i, j] = True
      j = int(m.dof_parentid[j])
  return mask


def _body_levels(m) -> tuple[np.ndarray, ...]:
  """Non-world bodies grouped by tree depth."""
  depth = np.zeros(m.nbody, dtype=int)
  for i in range(1, m.nbody):
    depth[i] = depth[m.body_parentid[i]] + 1
  top = depth.max() + 1 if m.nbody > 1 else 1
  return tuple(np.nonzero(depth == lv)[0] for lv in range(1, top))


def _body_masks(m) -> tuple[np.ndarray, np.ndarray]:
  """(subtree[i, j]: body j in subtree of i, body_dof[i, j]: dof j moves an
  ancestor-or-self of body i)."""
  ancestor = np.zeros((m.nbody, m.nbody), dtype=bool)
  for j in range(m.nbody):
    i = j
    while True:
      ancestor[j, i] = True
      if i == 0:
        break
      i = int(m.body_parentid[i])
  body_dof = np.zeros((m.nbody, m.nv), dtype=bool)
  for j in range(m.nv):
    body_dof[:, j] = ancestor[:, m.dof_bodyid[j]]
  return ancestor.T, body_dof


def contact_rows(condim: int, cone: int) -> int:
  """Constraint rows per contact slot."""
  if cone == ConeType.PYRAMIDAL:
    return 1 if condim == 1 else 2 * (condim - 1)
  return condim


def _tensor(x, dtype, device) -> torch.Tensor:
  """A copy of array-like `x` as a tensor (never a view of host memory)."""
  return torch.tensor(np.array(x), device=device).to(dtype)


def default_device() -> torch.device:
  """Entry points run on the card unless the caller asks for the CPU."""
  return torch.device("cuda")


_INTEGRATORS = {
  mjtIntegrator.mjINT_EULER: Integrator.EULER,
  mjtIntegrator.mjINT_RK4: Integrator.RK4,
  mjtIntegrator.mjINT_IMPLICIT: Integrator.IMPLICITFAST,
  mjtIntegrator.mjINT_IMPLICITFAST: Integrator.IMPLICITFAST,
}


def put_model(
  m, dtype=torch.float32, device: torch.device | str | None = None,
  capsule_terrain_from_above: bool = False, allocate_friction_rows: bool = False,
) -> tuple[Topology, Model]:
  """Convert a compiled model into (Topology, Model) on `device` (default
  CUDA). Builds the device index tables of every stage once, here.
  `capsule_terrain_from_above` is SimulationCfg's (a declared divergence,
  off by default); `allocate_friction_rows` gives every dof a friction-loss
  row even where its frictionloss is 0 (the JAX package's argument)."""
  device = torch.device(device) if device is not None else default_device()
  _reject_unsupported(m)

  pairs, groups = (tuple(x) for x in _candidate_pairs(m))
  ncon_max = sum(p.ncon for p in pairs) + sum(
    tg.slots * len(tg.robot_geoms) for tg in groups
  )
  cone = int(m.opt.cone)
  limited_joints = np.nonzero(
    (m.jnt_limited == 1)
    & np.isin(m.jnt_type, [mjtJoint.mjJNT_HINGE, mjtJoint.mjJNT_SLIDE])
  )[0]
  friction_dofs = (
    np.arange(m.nv) if allocate_friction_rows else np.nonzero(m.dof_frictionloss > 0)[0]
  )
  limited_tendons = np.nonzero(m.tendon_limited == 1)[0]
  neq_rows = sum(_EQ_ROWS[int(m.eq_type[e])] for e in range(m.neq) if m.eq_active0[e])
  empty = np.zeros(0, dtype=np.int64)
  nefc = (
    neq_rows
    + len(friction_dofs)
    + len(limited_joints)
    + len(limited_tendons)
    + sum(p.ncon * contact_rows(p.condim, cone) for p in pairs)
    + sum(
      tg.slots * sum(contact_rows(int(c), cone) for c in tg.condim)
      for tg in groups
    )
  )
  trn_qmat, trn_vmat, actuator_dyn_tendon = _transmission_matrices(m)
  tendon_qmat, tendon_vmat = _tendon_matrices(m)
  subtree, body_dof = _body_masks(m)
  # Hulls by mesh id, or by a tessellated primitive's type and size: geoms
  # that share a mesh or a size share one hull.
  hull_cache: dict[object, object] = {}
  geom_hulls = {}
  for g in hull_geoms(m, pairs, groups):
    t = int(m.geom_type[g])
    if t == _G.mjGEOM_MESH:
      key = int(m.geom_dataid[g])
      if key not in hull_cache:
        hull_cache[key] = build_hull(_hull_vertices(m, g))
    else:
      size = m.geom_size[g]
      key = (t, float(size[0]), float(size[1]), float(size[2]))
      if key not in hull_cache:
        hull_cache[key] = build_hull(_primitive_hull_vertices(t, size))
    geom_hulls[g] = hull_cache[key]

  tp = Topology(
    nq=m.nq, nv=m.nv, nu=m.nu, nbody=m.nbody, njnt=m.njnt, ngeom=m.ngeom,
    nsite=m.nsite, nsensor=m.nsensor, nsensordata=m.nsensordata,
    nmocap=m.nmocap,
    body_parentid=m.body_parentid.copy(),
    body_rootid=m.body_rootid.copy(),
    body_weldid=m.body_weldid.copy(),
    body_jntadr=m.body_jntadr.copy(),
    body_jntnum=m.body_jntnum.copy(),
    body_dofadr=m.body_dofadr.copy(),
    body_dofnum=m.body_dofnum.copy(),
    body_geomadr=m.body_geomadr.copy(),
    body_geomnum=m.body_geomnum.copy(),
    body_mocapid=m.body_mocapid.copy(),
    jnt_type=m.jnt_type.copy(),
    jnt_qposadr=m.jnt_qposadr.copy(),
    jnt_dofadr=m.jnt_dofadr.copy(),
    jnt_bodyid=m.jnt_bodyid.copy(),
    jnt_limited=m.jnt_limited.copy(),
    jnt_actfrclimited=m.jnt_actfrclimited.copy(),
    dof_bodyid=m.dof_bodyid.copy(),
    dof_jntid=m.dof_jntid.copy(),
    dof_parentid=m.dof_parentid.copy(),
    geom_type=m.geom_type.copy(),
    geom_bodyid=m.geom_bodyid.copy(),
    geom_condim=m.geom_condim.copy(),
    geom_priority=m.geom_priority.copy(),
    geom_dataid=m.geom_dataid.copy(),
    geom_hulls=geom_hulls,
    body_gravcomp_host=m.body_gravcomp.copy(),
    has_fluid=False,
    site_bodyid=m.site_bodyid.copy(),
    site_type=m.site_type.copy(),
    site_size=m.site_size.copy(),
    actuator_trntype=m.actuator_trntype.copy(),
    actuator_trnid=m.actuator_trnid.copy(),
    trn_qmat=trn_qmat,
    trn_vmat=trn_vmat,
    ntendon=m.ntendon,
    tendon_qmat=tendon_qmat,
    tendon_vmat=tendon_vmat,
    tendon_length0=m.tendon_length0.copy(),
    tendon_invweight0=m.tendon_invweight0.copy(),
    tendon_kind=np.zeros(m.ntendon, dtype=np.int32),
    tendon_seg_sites=np.full((m.ntendon, 1, 2), -1, dtype=np.int32),
    tendon_seg_scale=np.zeros((m.ntendon, 1)),
    tendon_seg_geom=np.full((m.ntendon, 1), -1, dtype=np.int32),
    tendon_seg_side=np.full((m.ntendon, 1), -1, dtype=np.int32),
    limited_tendon_ids=limited_tendons,
    actuator_dyn_tendon=actuator_dyn_tendon,
    actuator_gaintype=m.actuator_gaintype.copy(),
    actuator_biastype=m.actuator_biastype.copy(),
    actuator_ctrllimited=m.actuator_ctrllimited.copy(),
    actuator_forcelimited=m.actuator_forcelimited.copy(),
    na=0,
    actuator_dyntype=m.actuator_dyntype.copy(),
    actuator_actadr=m.actuator_actadr.copy(),
    actuator_actlimited=m.actuator_actlimited.copy(),
    actuator_actearly=m.actuator_actearly.copy(),
    act_actuator=np.zeros(0, dtype=np.int32),
    sensor_type=m.sensor_type.copy(),
    sensor_datatype=m.sensor_datatype.copy(),
    sensor_objtype=m.sensor_objtype.copy(),
    sensor_objid=m.sensor_objid.copy(),
    sensor_reftype=m.sensor_reftype.copy(),
    sensor_refid=m.sensor_refid.copy(),
    sensor_adr=m.sensor_adr.copy(),
    sensor_dim=m.sensor_dim.copy(),
    body_levels=_body_levels(m),
    dof_ancestor_mask=_dof_ancestor_mask(m),
    body_subtree_mask=subtree,
    body_dof_mask=body_dof,
    limited_joint_ids=limited_joints,
    limited_ball_joint_ids=empty,
    friction_dof_ids=friction_dofs,
    eq_type=m.eq_type.copy(),
    eq_obj1id=m.eq_obj1id.copy(),
    eq_obj2id=m.eq_obj2id.copy(),
    eq_objtype=m.eq_objtype.copy(),
    eq_active0=m.eq_active0.copy().astype(bool),
    neq_rows=neq_rows,
    pairs=pairs,
    terrain_groups=groups,
    ncon_max=ncon_max,
    nefc=nefc,
    nhfield=0,
    hfield_nrow=m.hfield_nrow.copy(),
    hfield_ncol=m.hfield_ncol.copy(),
    hfield_adr=m.hfield_adr.copy(),
    capsule_terrain_from_above=capsule_terrain_from_above,
  )
  tp = dataclasses.replace(tp, dev=device_tables(tp, dtype, device, cone))

  def arr(x):
    return _tensor(x, dtype, device)

  opt = m.opt
  option = Option(
    timestep=arr(opt.timestep),
    gravity=arr(opt.gravity),
    magnetic=arr(opt.magnetic),
    impratio=arr(opt.impratio),
    tolerance=arr(opt.tolerance),
    ls_tolerance=arr(opt.ls_tolerance),
    density=arr(opt.density),
    viscosity=arr(opt.viscosity),
    wind=arr(opt.wind),
    integrator=_INTEGRATORS[int(opt.integrator)],
    cone=cone,
    solver=int(opt.solver),
    iterations=int(opt.iterations),
    ls_iterations=int(opt.ls_iterations),
  )
  leaves = {}
  for f in model_fields():
    if f.startswith("pair_") or f.startswith("hfield_") or (
      f.startswith("eq_") and not m.neq
    ):
      continue  # empty: rejected above, or no equality constraint
    leaves[f] = arr(getattr(m, f))
  width = {"pair_friction": 5, "pair_solref": 2, "pair_solreffriction": 2,
           "pair_solimp": 5, "pair_margin": None, "hfield_data": None,
           "hfield_size": 4, "eq_solref": 2, "eq_solimp": 5, "eq_data": 11}
  for f, w in width.items():
    if f not in leaves:
      leaves[f] = arr(np.zeros((0,) if w is None else (0, w)))
  return tp, Model(opt=option, **leaves)


def device_tables(tp: Topology, dtype, device, cone: int = ConeType.PYRAMIDAL) -> SimpleNamespace:
  """Upload every stage's index and mask tensors (one namespace each)."""
  from mjlab_tpu_torch.physics import collision, constraint, kinematics, smooth

  return SimpleNamespace(
    kin=kinematics.device_tables(tp, dtype, device),
    smooth=smooth.device_tables(tp, dtype, device),
    coll=collision.device_tables(tp, dtype, device),
    con=constraint.device_tables(tp, dtype, device, cone),
  )


def make_data(tp: Topology, model: Model, num_envs: int) -> Data:
  """Fresh batched Data at qpos0 ((nq,) or per env (B, nq)). Call forward()
  to populate derived state."""
  dtype, device = model.qpos0.dtype, model.qpos0.device
  B, C = num_envs, tp.ncon_max

  def z(*shape):
    return torch.zeros((B,) + shape, dtype=dtype, device=device)

  def tile(values, *shape):
    t = torch.as_tensor(values, dtype=dtype, device=device)
    return t.expand((B,) + shape + t.shape).clone()

  eye3 = torch.eye(3, dtype=dtype, device=device)
  contact = Contact(
    dist=torch.full((B, C), 1e10, dtype=dtype, device=device),
    pos=z(C, 3),
    frame=tile(eye3, C),
    includemargin=z(C),
    friction=tile([1.0, 1.0, 0.005, 0.0001, 0.0001], C),
    solref=tile([0.02, 1.0], C),
    solimp=tile([0.9, 0.95, 0.001, 0.5, 2.0], C),
    solreffriction=z(C, 2),
  )
  return Data(
    time=z(),
    qpos=model.qpos0.expand(B, tp.nq).clone(),
    qvel=z(tp.nv),
    act=z(tp.na),
    ctrl=z(tp.nu),
    qfrc_applied=z(tp.nv),
    xfrc_applied=z(tp.nbody, 6),
    mocap_pos=z(tp.nmocap, 3),
    mocap_quat=tile([1.0, 0, 0, 0], tp.nmocap),
    qacc_warmstart=z(tp.nv),
    xanchor=z(tp.njnt, 3),
    xaxis=z(tp.njnt, 3),
    xpos=z(tp.nbody, 3),
    xquat=tile([1.0, 0, 0, 0], tp.nbody),
    xmat=tile(eye3, tp.nbody),
    xipos=z(tp.nbody, 3),
    ximat=tile(eye3, tp.nbody),
    geom_xpos=z(tp.ngeom, 3),
    geom_xmat=tile(eye3, tp.ngeom),
    site_xpos=z(tp.nsite, 3),
    site_xmat=tile(eye3, tp.nsite),
    ten_length=z(tp.ntendon),
    ten_velocity=z(tp.ntendon),
    ten_J=z(tp.ntendon, tp.nv),
    subtree_com=z(tp.nbody, 3),
    cinert=z(tp.nbody, 10),
    cdof=z(tp.nv, 6),
    cvel=z(tp.nbody, 6),
    cdof_dot=z(tp.nv, 6),
    qM=z(tp.nv, tp.nv),
    qLD=z(tp.nv, tp.nv),
    qfrc_bias=z(tp.nv),
    qfrc_passive=z(tp.nv),
    qfrc_spring=z(tp.nv),
    qfrc_damper=z(tp.nv),
    actuator_length=z(tp.nu),
    actuator_velocity=z(tp.nu),
    actuator_force=z(tp.nu),
    act_dot=z(tp.na),
    qfrc_actuator=z(tp.nv),
    qfrc_smooth=z(tp.nv),
    qacc_smooth=z(tp.nv),
    contact=contact,
    efc_J=z(tp.nefc, tp.nv),
    efc_D=z(tp.nefc),
    efc_aref=z(tp.nefc),
    efc_pos=z(tp.nefc),
    efc_margin=z(tp.nefc),
    efc_frictionloss=z(tp.nefc),
    efc_force=z(tp.nefc),
    qfrc_constraint=z(tp.nv),
    qacc=z(tp.nv),
    sensordata=z(tp.nsensordata),
    subtree_linvel=z(tp.nbody, 3),
    subtree_angmom=z(tp.nbody, 3),
    ncon_dropped=torch.zeros(B, dtype=torch.int32, device=device),
  )


def model_fields() -> list[str]:
  """Names of the Model's parameter leaves (all but opt)."""
  return [f.name for f in dataclasses.fields(Model) if f.name != "opt"]


# ---------------------------------------------------------------------------
# Carrying state across: numpy dicts ⇄ port types. The tests feed both
# engines the same model (including randomized leaves) and the same states.
# ---------------------------------------------------------------------------


def model_from_arrays(
  arrays: dict[str, np.ndarray], dtype=torch.float32, device=None
) -> Model:
  """Model from numpy leaves named as the JAX package's Model fields; the
  option leaves are named `opt.<field>` (static ones as 0-d integers)."""
  device = torch.device(device) if device is not None else default_device()

  def arr(x):
    return _tensor(x, dtype, device)

  opt_kw = {}
  for f in dataclasses.fields(Option):
    x = arrays[f"opt.{f.name}"]
    opt_kw[f.name] = (
      type(f.default)(np.asarray(x).item()) if f.name in OPTION_STATIC else arr(x)
    )
  return Model(opt=Option(**opt_kw), **{f: arr(arrays[f]) for f in model_fields()})


def _data_leaves(d) -> dict[str, object]:
  out = {}
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    if dataclasses.is_dataclass(v):
      for g in dataclasses.fields(v):
        out[f"{f.name}.{g.name}"] = getattr(v, g.name)
    else:
      out[f.name] = v
  return out


def data_to_arrays(d: Data) -> dict[str, np.ndarray]:
  """Batched Data → {field or contact.<field>: numpy array}."""
  return {k: v.detach().cpu().numpy() for k, v in _data_leaves(d).items()}


def data_from_arrays(
  arrays: dict[str, np.ndarray], dtype=torch.float32, device=None
) -> Data:
  """Batched Data from numpy leaves (the names `data_to_arrays` writes).
  Integer leaves keep an integer dtype."""
  device = torch.device(device) if device is not None else default_device()

  def arr(x):
    x = np.asarray(x)
    t = dtype if np.issubdtype(x.dtype, np.floating) else torch.int32
    return _tensor(x, t, device)

  contact = Contact(
    **{f.name: arr(arrays[f"contact.{f.name}"]) for f in dataclasses.fields(Contact)}
  )
  kw = {
    f.name: arr(arrays[f.name]) for f in dataclasses.fields(Data)
    if f.name != "contact"
  }
  return Data(contact=contact, **kw)
