"""A generated terrain put into a robot's compiled scene, without MjSpec.

The JAX package builds the terrain into an MjSpec and compiles the robot's
scene around it. The card host has no `mujoco`, so the port starts from the
same robot's scene compiled with the plane terrain (`terrain_type="plane"`,
a committed npz) and replaces the terrain body's one plane geom by the
generated geoms. The two compiles differ only where the terrain body's
geoms enter: the geom arrays, the height field assets, the names, the
bodies' geom addresses, and the terrain body's inertia. `compose_terrain`
recomputes each of them as MuJoCo's compiler does:

- each generated geom gets MuJoCo's geom defaults (not the plane's
  friction, which came from `TerrainImporterCfg.friction`), its name
  `<prefix>terrain_<k>` and its height field `<prefix>hfield_<row>_<col>`,
  where `<prefix>` is the terrain body's (the scene attaches the terrain
  under "/");
- `geom_aabb`, `geom_rbound`, `geom_sameframe`, a height field geom's
  size (its asset's half extents and the mean of half its elevation and its
  base) and `geom_dataid`;
- the terrain body's mass, center of mass and principal inertia from its
  geoms, each a solid box of density 1000 (a height field is the box of its
  geom size), with MuJoCo's eigen-decomposition (`_eig3`), and every
  body's `body_subtreemass`;
- the names buffer and every `name_*adr`, in MuJoCo's order.

The fields that change with the geoms but that no port code reads
(`_STALE`: the names hash map, the bounding-volume hierarchy's counts and
addresses, the buffer and arena sizes) are left out, so that a later read
fails loudly instead of seeing the plane scene's value.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from mjlab_tpu_torch.physics.types import mjtGeom, mjtObj, mjtWrap
from mjlab_tpu_torch.terrains.terrain_generator import GeneratedTerrain

# MjModel's name address arrays, in the order MuJoCo's compiler writes the
# names buffer (after the model's own name).
NAME_ORDER = (
  "body", "jnt", "geom", "site", "cam", "light", "flex", "mesh", "skin", "hfield",
  "tex", "mat", "pair", "exclude", "eq", "tendon", "actuator", "sensor", "numeric",
  "text", "tuple", "key", "plugin",
)

# Fields that change with the terrain's geoms and that the port never reads.
_STALE = ("names_map", "nnames_map", "nbuffer", "narena", "nbvh", "nbvhstatic",
          "body_bvhadr", "body_bvhnum")

RTOL = 1e-12  # `mismatches`' float tolerance, relative to a field's largest magnitude
_DENSITY = 1000.0  # MuJoCo's default geom density
_EIG_EPS = 1e-12  # mju_eig3's convergence threshold
_MINVAL = 1e-15  # mjMINVAL


def _geom_defaults(nuser: int) -> dict[str, np.ndarray]:
  """MuJoCo's geom defaults for the geom fields a generated geom does not
  set itself."""
  return {
    "geom_contype": 1, "geom_conaffinity": 1, "geom_condim": 3, "geom_group": 0,
    "geom_priority": 0, "geom_matid": -1, "geom_plugin": -1, "geom_solmix": 1.0,
    "geom_solref": (0.02, 1.0), "geom_solimp": (0.9, 0.95, 0.001, 0.5, 2.0),
    "geom_friction": (1.0, 0.005, 0.0001), "geom_margin": 0.0, "geom_gap": 0.0,
    "geom_fluid": (0.0,) * 12, "geom_user": np.zeros(nuser), "geom_quat": (1.0, 0.0, 0.0, 0.0),
    "geom_hull_vertadr": -1, "geom_hull_vertnum": 0,
  }


def _names(arrays: dict[str, np.ndarray]) -> tuple[bytes, dict[str, list[bytes]]]:
  """The model's own name and every category's names, from the buffer."""
  buf = arrays["names"].tobytes()

  def at(adr: int) -> bytes:
    return buf[adr : buf.index(b"\0", adr)]

  return at(0), {k: [at(int(a)) for a in arrays[f"name_{k}adr"]] for k in NAME_ORDER}


def _names_buffer(model_name: bytes, names: dict[str, list[bytes]]) -> dict[str, np.ndarray]:
  """The names buffer and the `name_*adr` arrays, as the compiler writes them."""
  out, parts, adr = {}, [model_name + b"\0"], len(model_name) + 1
  for k in NAME_ORDER:
    adrs = []
    for name in names[k]:
      adrs.append(adr)
      parts.append(name + b"\0")
      adr += len(name) + 1
    out[f"name_{k}adr"] = np.asarray(adrs, dtype=np.int32)
  out["names"] = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
  return out


# -- MuJoCo's 3x3 eigen-decomposition (engine_util_solve.c mju_eig3) --------


def _quat2mat(q) -> list[float]:
  if q[0] == 1 and q[1] == 0 and q[2] == 0 and q[3] == 0:
    return [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
  q00, q01, q02, q03 = q[0] * q[0], q[0] * q[1], q[0] * q[2], q[0] * q[3]
  q11, q12, q13 = q[1] * q[1], q[1] * q[2], q[1] * q[3]
  q22, q23, q33 = q[2] * q[2], q[2] * q[3], q[3] * q[3]
  return [
    q00 + q11 - q22 - q33, 2 * (q12 - q03), 2 * (q13 + q02),
    2 * (q12 + q03), q00 - q11 + q22 - q33, 2 * (q23 - q01),
    2 * (q13 - q02), 2 * (q23 + q01), q00 - q11 - q22 + q33,
  ]


def _mul_quat(a, b) -> list[float]:
  return [
    a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
    a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
    a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
    a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0],
  ]


def _normalize4(q) -> list[float]:
  norm = math.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
  if norm < _MINVAL:
    return [1.0, 0.0, 0.0, 0.0]
  if abs(norm - 1) > _MINVAL:
    inv = 1 / norm
    return [x * inv for x in q]
  return list(q)


def _mat_t_mat(a, b) -> list[float]:
  """a' b for row-major 3x3 lists, summed as MuJoCo sums."""
  return [a[j] * b[k] + a[3 + j] * b[3 + k] + a[6 + j] * b[6 + k]
          for j in range(3) for k in range(3)]


def _mat_mat(a, b) -> list[float]:
  return [a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k] + a[3 * i + 2] * b[6 + k]
          for i in range(3) for k in range(3)]


def _eig3(mat) -> tuple[list[float], list[float]]:
  """(eigenvalues in decreasing order, the quaternion of the eigenvectors)
  of a symmetric 3x3 matrix: MuJoCo's Jacobi iteration on a quaternion."""
  quat = [1.0, 0.0, 0.0, 0.0]
  eigval = [0.0, 0.0, 0.0]
  for _ in range(500):
    vec = _quat2mat(quat)
    d = _mat_mat(_mat_t_mat(vec, mat), vec)
    eigval = [d[0], d[4], d[8]]
    if abs(d[1]) > abs(d[2]) and abs(d[1]) > abs(d[5]):
      rk, ck, rotk = 0, 1, 2
    elif abs(d[2]) > abs(d[5]):
      rk, ck, rotk = 0, 2, 1
    else:
      rk, ck, rotk = 1, 2, 0
    if abs(d[3 * rk + ck]) < _EIG_EPS:
      break
    tau = (d[4 * ck] - d[4 * rk]) / (2 * d[3 * rk + ck])
    if tau >= 0:
      t = 1.0 / (tau + math.sqrt(1.0 + tau * tau))
    else:
      t = -1.0 / (-tau + math.sqrt(1.0 + tau * tau))
    c = 1.0 / math.sqrt(1.0 + t * t)
    if c > 1.0 - _EIG_EPS:
      break
    rot = [0.0, 0.0, 0.0, 0.0]
    rot[rotk + 1] = -math.sqrt(0.5 - 0.5 * c) if tau >= 0 else math.sqrt(0.5 - 0.5 * c)
    if rotk == 1:
      rot[rotk + 1] = -rot[rotk + 1]
    rot[0] = math.sqrt(1.0 - rot[rotk + 1] * rot[rotk + 1])
    rot = _normalize4(rot)
    quat = _normalize4(_mul_quat(quat, rot))
  # Sort the eigenvalues in decreasing order (bubble sort: 0, 1, 0).
  for j in range(3):
    j1 = j % 2
    if eigval[j1] < eigval[j1 + 1]:
      eigval[j1], eigval[j1 + 1] = eigval[j1 + 1], eigval[j1]
      rot = [0.707106781186548, 0.0, 0.0, 0.0]
      rot[(j1 + 2) % 3 + 1] = rot[0]
      quat = _normalize4(_mul_quat(quat, rot))
  return eigval, quat


def _box_inertial(size) -> tuple[float, list[float]]:
  """(mass, principal inertia) of a solid box of half extents `size`."""
  mass = _DENSITY * (size[0] * size[1] * size[2] * 8)
  return mass, [
    mass * (size[1] * size[1] + size[2] * size[2]) / 3,
    mass * (size[0] * size[0] + size[2] * size[2]) / 3,
    mass * (size[0] * size[0] + size[1] * size[1]) / 3,
  ]


def _inertia_from_geoms(pos: np.ndarray, size: np.ndarray):
  """(mass, ipos, iquat, inertia) of a body from its geoms, each a solid
  box at its position with an identity orientation (mjCBody::InertiaFromGeom)."""
  inertials = [_box_inertial([float(x) for x in s]) for s in size]
  p = [[float(x) for x in row] for row in pos]
  if len(p) == 1:
    mass, inertia = inertials[0]
    return mass, p[0], [1.0, 0.0, 0.0, 0.0], inertia
  mass, com = 0.0, [0.0, 0.0, 0.0]
  for (m, _), x in zip(inertials, p):
    mass += m
    com = [com[0] + m * x[0], com[1] + m * x[1], com[2] + m * x[2]]
  ipos = [com[0] / mass, com[1] / mass, com[2] / mass]
  full = [0.0] * 6
  for (m, inertia), x in zip(inertials, p):
    d = [x[0] - ipos[0], x[1] - ipos[1], x[2] - ipos[2]]
    off = [
      m * (d[1] * d[1] + d[2] * d[2]), m * (d[0] * d[0] + d[2] * d[2]),
      m * (d[0] * d[0] + d[1] * d[1]),
      -m * d[0] * d[1], -m * d[0] * d[2], -m * d[1] * d[2],
    ]
    own = [inertia[0], inertia[1], inertia[2], 0.0, 0.0, 0.0]
    full = [full[j] + own[j] + off[j] for j in range(6)]
  mat = [full[0], full[3], full[4], full[3], full[1], full[5], full[4], full[5], full[2]]
  eigval, quat = _eig3(mat)
  return mass, ipos, quat, eigval


# -- the composition ---------------------------------------------------------


def _generated_geom_arrays(generated: GeneratedTerrain, body: int):
  """The generated geoms' own fields (type, pos, size, rgba, dataid, aabb,
  rbound, sameframe) and their height field assets, numbered from 0."""
  geoms = generated.geoms
  k = len(geoms)
  out = {
    "geom_type": np.empty(k, np.int64), "geom_pos": np.empty((k, 3)),
    "geom_size": np.empty((k, 3)), "geom_rgba": np.empty((k, 4)),
    "geom_dataid": np.full(k, -1, np.int64), "geom_aabb": np.empty((k, 6)),
    "geom_rbound": np.empty(k), "geom_bodyid": np.full(k, body, np.int64),
  }
  hfields = []
  for i, g in enumerate(geoms):
    out["geom_pos"][i] = g.pos
    out["geom_rgba"][i] = g.rgba
    if g.type == "box":
      s = np.asarray(g.size, dtype=np.float64)
      out["geom_type"][i] = mjtGeom.mjGEOM_BOX
      out["geom_aabb"][i] = (0.0, 0.0, 0.0, s[0], s[1], s[2])
      out["geom_rbound"][i] = math.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2])
    elif g.type == "hfield":
      hs = [float(x) for x in g.hfield.size]
      s = np.array([hs[0], hs[1], 0.25 * hs[2] + 0.5 * hs[3]])
      out["geom_type"][i] = mjtGeom.mjGEOM_HFIELD
      out["geom_dataid"][i] = len(hfields)
      out["geom_aabb"][i] = (0.0, 0.0, 0.5 * (hs[2] - hs[3]), hs[0], hs[1],
                             0.5 * (hs[2] + hs[3]))
      top = max(hs[2], hs[3])
      out["geom_rbound"][i] = math.sqrt(hs[0] * hs[0] + hs[1] * hs[1] + top * top)
      hfields.append(g.hfield)
    else:
      raise ValueError(f"unknown terrain geom type {g.type!r}")
    out["geom_size"][i] = s
  # The compiler tests BODY, then BODYROT, then INERTIA: a generated geom
  # has the identity orientation, so it is BODYROT wherever it is not at the
  # body's origin, even at the body's inertial frame (a terrain of one geom).
  pos = out["geom_pos"]
  out["geom_sameframe"] = np.where((pos == 0).all(axis=1), 1, 3)  # BODY, else BODYROT
  return out, hfields


def _shift_geom_refs(arrays: dict, first: int, delta: int) -> None:
  """Move every reference to a geom after the terrain's plane (`first`) by
  `delta`; a reference to the plane itself has no generated counterpart."""

  def shift(key, mask=None):
    v = arrays.get(key)
    if v is None or not len(v):
      return
    ref = np.ones(v.shape, bool) if mask is None else mask
    if (ref & (v == first)).any():
      raise NotImplementedError(
        f"{key} references the terrain plane, which a generator terrain replaces"
      )
    arrays[key] = np.where(ref & (v > first), v + delta, v).astype(v.dtype)

  shift("pair_geom1")
  shift("pair_geom2")
  if "sensor_objid" in arrays and len(arrays["sensor_objid"]):
    shift("sensor_objid", arrays["sensor_objtype"] == mjtObj.mjOBJ_GEOM)
    shift("sensor_refid", arrays["sensor_reftype"] == mjtObj.mjOBJ_GEOM)
  if "wrap_objid" in arrays and len(arrays["wrap_objid"]):
    shift("wrap_objid", np.isin(arrays["wrap_type"],
                                (mjtWrap.mjWRAP_SPHERE, mjtWrap.mjWRAP_CYLINDER)))


def compose_arrays(robot_arrays: dict[str, np.ndarray],
                   generated: GeneratedTerrain) -> dict[str, np.ndarray]:
  """The arrays (`assets.model_arrays`' keys) of the scene compiled with
  the generated terrain, from those of the same scene compiled with the
  plane terrain."""
  a = {k: np.asarray(v) for k, v in robot_arrays.items() if k not in _STALE}
  model_name, names = _names(a)
  body_names = names["body"]
  terrain = [i for i, n in enumerate(body_names) if n.rsplit(b"/", 1)[-1] == b"terrain"]
  if len(terrain) != 1:
    raise NotImplementedError(
      "a generator terrain is composed onto a scene compiled with terrain_type "
      f"'plane': the scene has {len(terrain)} bodies named 'terrain', not 1"
    )
  b = terrain[0]
  g0, ng = int(a["body_geomadr"][b]), int(a["body_geomnum"][b])
  if ng != 1 or int(a["geom_type"][g0]) != mjtGeom.mjGEOM_PLANE:
    raise NotImplementedError(
      "a generator terrain is composed onto a scene compiled with terrain_type "
      "'plane' (its terrain body one plane geom); this scene's terrain body has "
      f"{ng} geoms"
    )
  if int(a["nhfield"]) or int(a["body_dofnum"][b]):
    raise NotImplementedError(
      "a generator terrain is composed onto a scene with no height field of its "
      "own and a static terrain body"
    )
  prefix = body_names[b][: -len(b"terrain")]
  k = len(generated.geoms)
  delta = k - 1

  own, hfields = _generated_geom_arrays(generated, b)
  defaults = _geom_defaults(int(a.get("nuser_geom", 0)))
  geom_keys = [key for key in a if key.startswith("geom_") and key != "geom_hull_vert"]
  for key in geom_keys:
    if key in own:
      block = own[key]
    elif key in defaults:
      block = np.broadcast_to(np.asarray(defaults[key], dtype=np.float64),
                              (k,) + a[key].shape[1:])
    else:
      raise NotImplementedError(f"no terrain geom value for the compiled field {key}")
    a[key] = np.concatenate([a[key][:g0], block.astype(a[key].dtype), a[key][g0 + 1 :]])

  # Bodies: the geom addresses after the terrain's, and its inertia.
  geomadr = a["body_geomadr"].copy()
  geomadr[(np.arange(len(geomadr)) > b) & (geomadr >= 0)] += delta
  a["body_geomadr"] = geomadr
  a["body_geomnum"] = a["body_geomnum"].copy()
  a["body_geomnum"][b] = k
  mass, ipos, iquat, inertia = _inertia_from_geoms(own["geom_pos"], own["geom_size"])
  for key, v in (("body_mass", mass), ("body_ipos", ipos), ("body_iquat", iquat),
                 ("body_inertia", inertia)):
    a[key] = a[key].copy()
    a[key][b] = v
  same = 1 if ipos == [0.0, 0.0, 0.0] and iquat == [1.0, 0.0, 0.0, 0.0] else (
    3 if iquat == [1.0, 0.0, 0.0, 0.0] else 0)
  for key, v in (("body_sameframe", same), ("body_simple", int(same == 1))):
    a[key] = a[key].copy()
    a[key][b] = v
  new = slice(g0, g0 + k)
  for key, reduce in (("body_contype", np.bitwise_or.reduce),
                      ("body_conaffinity", np.bitwise_or.reduce),
                      ("body_margin", np.max)):
    if key in a:
      a[key] = a[key].copy()
      a[key][b] = reduce(a[key.replace("body_", "geom_")][new])
  subtree = a["body_mass"].astype(np.float64).copy()
  parent = a["body_parentid"]
  for i in range(len(subtree) - 1, 0, -1):
    subtree[parent[i]] += subtree[i]
  a["body_subtreemass"] = subtree
  _shift_geom_refs(a, g0, delta)

  # Height field assets.
  if hfields:
    sizes = [np.asarray(h.data, dtype=np.float32).size for h in hfields]
    a["hfield_size"] = np.array([h.size for h in hfields], dtype=np.float64)
    a["hfield_nrow"] = np.array([h.nrow for h in hfields], dtype=np.int32)
    a["hfield_ncol"] = np.array([h.ncol for h in hfields], dtype=np.int32)
    a["hfield_adr"] = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    a["hfield_data"] = np.concatenate([np.asarray(h.data, dtype=np.float32) for h in hfields])
    a["hfield_pathadr"] = np.full(len(hfields), -1, dtype=np.int32)
  a["nhfield"] = np.asarray(len(hfields))
  a["nhfielddata"] = np.asarray(sum(int(np.asarray(h.data).size) for h in hfields))

  # Names.
  names["geom"][g0 : g0 + 1] = [prefix + f"terrain_{i}".encode() for i in range(k)]
  names["hfield"] = [prefix + h.name.encode() for h in hfields]
  a.update(_names_buffer(model_name, names))
  a["ngeom"] = np.asarray(len(names["geom"]))
  a["nnames"] = np.asarray(len(a["names"]))
  a["terrain_origins"] = np.asarray(generated.terrain_origins, dtype=np.float64)
  return a


def compose_terrain(robot_arrays: dict[str, np.ndarray],
                    generated: GeneratedTerrain) -> SimpleNamespace:
  """A namespace like `assets.load_model_npz`'s: the scene of
  `robot_arrays` (compiled with the plane terrain) with the generated
  terrain in place of the plane, and the tiles' origins."""
  from mjlab_tpu_torch.assets import model_namespace

  return model_namespace(compose_arrays(robot_arrays, generated))


def mismatches(reference: dict[str, np.ndarray], composed: dict[str, np.ndarray]) -> list[str]:
  """Where `composed` departs from `reference`, a compile of the same scene
  (`assets.model_arrays`' keys; the reference's `_STALE` fields are not
  compared): a missing or extra key, a shape or dtype, an integer that is
  not equal, or a float off by more than RTOL times the field's largest
  magnitude."""
  out = []
  want = {k: np.asarray(v) for k, v in reference.items() if k not in _STALE}
  got = {k: np.asarray(v) for k, v in composed.items()}
  for key in sorted(set(want) ^ set(got)):
    out.append(f"{key}: only in {'the reference' if key in want else 'the composition'}")
  for key in sorted(set(want) & set(got)):
    w, g = want[key], got[key]
    if w.shape != g.shape or w.dtype != g.dtype:
      out.append(f"{key}: {g.dtype}{g.shape}, not {w.dtype}{w.shape}")
    elif w.dtype.kind == "f":
      err = float(np.max(np.abs(g - w), initial=0.0))
      scale = float(np.max(np.abs(w), initial=0.0))
      if not err <= RTOL * scale:
        out.append(f"{key}: max abs err {err:.3e} > {RTOL:.0e} x {scale:.3e}")
    elif not np.array_equal(w, g):
      out.append(f"{key}: {int(np.sum(w != g))} entries differ")
  return out
