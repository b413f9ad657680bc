"""The hull SAT of the PyTorch port (`physics/convex.py` `convex_convex`,
`_clip_polygon`, the hull constants, `pad_hulls`; `physics/collision.py`
`_convex_group`) against the JAX package (float64, CPU), on seeded poses:
box–box, box against an Asimov foot hull, sphere–hull, capsule–hull,
hull–hull, a tessellated cylinder, a box resting flat on a box (equal-depth
ties), a box straddling 2 and 4 coplanar tiles, separated pairs and deep
penetration; and every static convex pair of a toy scene through the whole
`collision`. 1e-9 on every output, elementwise (relative to max(1, |JAX|)).

One difference is the reference's own: where no clip point exists, the
contact is the midpoint of the two hulls' support points along the axis,
and on an edge–edge or vertex axis two support points tie exactly (the
axis is perpendicular to an edge); the JAX package takes whichever its
rounding makes larger (XLA's fused multiply-adds), the port whichever its
own does. There the test asks that both positions be among the midpoints
of the tied supports (`_tied_positions`), and that everything else agree
at 1e-9 (ROADMAP Queue C)."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import collision as jcoll
from mjlab_tpu.physics import convex as jc
from mjlab_tpu.physics.kinematics import kinematics as jkinematics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import convex as tc
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import mjtGeom as _G

N = 240  # seeded poses per case
TOL = 1e-9


@functools.lru_cache(maxsize=None)
def _hulls() -> dict[str, jc.Hull]:
  """The JAX package's hulls of the cases: the Asimov left foot (from the
  committed scene's hull vertices) and a tessellated cylinder."""
  foot = tio._hull_vertices(assets.load_model_npz(assets.ASIMOV_VELOCITY_FLAT), 7)
  cyl = tio._primitive_hull_vertices(_G.mjGEOM_CYLINDER, np.array([0.06, 0.05, 0.0]))
  return {"box": jc.BOX_HULL, "foot": jc.build_hull(foot), "cylinder": jc.build_hull(cyl),
          "sphere": jc.SPHERE_HULL, "capsule": jc.CAPSULE_HULL}


def test_hull_constants_equal_jax():
  for name in ("BOX_HULL", "SPHERE_HULL", "CAPSULE_HULL"):
    t, j = getattr(tc, name), getattr(jc, name)
    for f in ("verts", "face_verts", "face_normals", "edge_dirs"):
      a, b = getattr(t, f), getattr(j, f)
      assert a.dtype == b.dtype and np.array_equal(a, b), f"{name}.{f}"
      assert np.array_equal(np.signbit(a), np.signbit(b)), f"{name}.{f} signs"
  assert (tc.EDGE_AXIS_BUDGET, tc.MAX_HULL_VERTS, tc.MAX_FACE_VERTS) == (
    jc.EDGE_AXIS_BUDGET, jc.MAX_HULL_VERTS, jc.MAX_FACE_VERTS)
  # The box hull is what build_hull makes of the 8 corners.
  box = tc.build_hull(tc.BOX_HULL.verts)
  for f in ("verts", "face_verts", "face_normals", "edge_dirs"):
    assert np.array_equal(getattr(box, f), getattr(tc.BOX_HULL, f)), f


def test_pad_hulls_equals_jax():
  h = _hulls()
  group = [h["foot"], h["box"], h["cylinder"]]
  for a, b in zip(tc.pad_hulls(group), jc.pad_hulls(group), strict=True):
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_clip_polygon_matches_jax():
  """Random faces of a rotated box (reference rings, pads included) clip
  random polygons lying near their planes."""
  rng = np.random.default_rng(0)
  h = jc.BOX_HULL
  n = 256
  rot = Rotation.random(n, random_state=rng).as_matrix()
  size = rng.uniform(0.05, 0.3, (n, 3))
  face = rng.integers(0, 6, n)
  verts = np.einsum("nij,nvj->nvi", rot, h.verts[None] * size[:, None])
  ring = verts[np.arange(n)[:, None], h.face_verts[face]]  # (n, 8, 3)
  normal = np.einsum("nij,nj->ni", rot, h.face_normals[face])
  k = rng.integers(3, 9, n)
  ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 8)), axis=-1)
  rad = rng.uniform(0.05, 0.4, (n, 1))
  centre = ring[:, :4].mean(1) + rng.normal(0, 0.1, (n, 3))
  t1 = np.cross(normal, [0.3, 0.5, 0.8])
  t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
  t2 = np.cross(normal, t1)
  poly = centre[:, None] + rad[..., None] * (np.cos(ang)[..., None] * t1[:, None]
                                             + np.sin(ang)[..., None] * t2[:, None])
  poly = np.where((np.arange(8) < k[:, None])[..., None], poly,
                  poly[np.arange(n), k - 1][:, None])  # pad by repetition
  jv = jax.vmap(jc._prefix_valid)(jnp.asarray(poly))
  want = jax.jit(jax.vmap(jc._clip_polygon))(jnp.asarray(poly), jv, jnp.asarray(ring),
                                             jnp.asarray(normal))
  tv = tc._prefix_valid(torch.as_tensor(poly))
  np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
  got = tc._clip_polygon(torch.as_tensor(poly), tv, torch.as_tensor(ring),
                         torch.as_tensor(normal))
  np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
  tp.close_elementwise(got[0].numpy(), want[0], "clipped points")
  assert 0 < got[1].sum(-1).float().mean() < 16


# ---------------------------------------------------------------------------
# convex_convex on seeded poses, case by case.
# ---------------------------------------------------------------------------

BOTH = dict(use_edge_axes=True, vertex_axes=False, clip_mode="both")


def _yaw(rng, n, quarter: bool = False) -> np.ndarray:
  yaw = rng.integers(0, 4, n) * np.pi / 2 if quarter else rng.uniform(-np.pi, np.pi, n)
  return Rotation.from_euler("z", yaw[:, None]).as_matrix()


def _case(name: str, rng):
  """(hull 1, hull 2, per-pose scales (n, 1, 3) or 1, r1, r2, ncon, flags,
  p1, m1, p2, m2) of a case."""
  h = _hulls()
  rot = lambda: Rotation.random(N, random_state=rng).as_matrix()  # noqa: E731
  box1 = rng.uniform(0.05, 0.3, (N, 1, 3))
  near = lambda s: (rng.normal(0, s, (N, 3)), rng.normal(0, s, (N, 3)))  # noqa: E731
  if name == "box_box":
    p1, p2 = near(0.15)
    return "box", "box", box1, rng.uniform(0.05, 0.3, (N, 1, 3)), 0.0, 0.0, 4, BOTH, \
      p1, rot(), p2, rot()
  if name == "box_foot":  # a terrain box (geom1) against the foot (geom2)
    p1, p2 = near(0.15)
    return "box", "foot", box1, 1.0, 0.0, 0.0, 4, BOTH, p1, rot(), p2, rot()
  if name == "foot_foot":  # 89 x 89 edge pairs: over the budget, no edge axes
    p1, p2 = near(0.05)
    flags = tcoll._convex_flags(_G.mjGEOM_MESH, _G.mjGEOM_MESH, 89, 89)
    assert flags == dict(use_edge_axes=False, vertex_axes=False, clip_mode="both")
    return "foot", "foot", 1.0, 1.0, 0.0, 0.0, 4, flags, p1, rot(), p2, rot()
  if name == "sphere_foot":
    p1, p2 = near(0.08)
    return "sphere", "foot", 0.0, 1.0, rng.uniform(0.02, 0.1, N), 0.0, 1, \
      tcoll._convex_flags(_G.mjGEOM_SPHERE, _G.mjGEOM_MESH, 1, 89), p1, rot(), p2, rot()
  if name == "capsule_foot":
    p1, p2 = near(0.1)
    hl = rng.uniform(0.05, 0.2, (N, 1, 1))
    return "capsule", "foot", hl, 1.0, rng.uniform(0.02, 0.06, N), 0.0, 2, \
      tcoll._convex_flags(_G.mjGEOM_CAPSULE, _G.mjGEOM_MESH, 1, 89), p1, rot(), p2, rot()
  if name == "box_cylinder":
    p1, p2 = near(0.12)
    return "box", "cylinder", box1, 1.0, 0.0, 0.0, 4, BOTH, p1, rot(), p2, rot()
  if name == "cylinder_cylinder":
    p1, p2 = near(0.06)
    return "cylinder", "cylinder", 1.0, 1.0, 0.0, 0.0, 4, BOTH, p1, rot(), p2, rot()
  if name in ("box_flat_on_box", "box_straddling_tiles"):
    # A level tile (top at z = 0) and a level box sinking 0-1 cm into it, at
    # quarter-turn yaws: 4 corners at one depth. Straddling: the box's
    # centre on the tile's edge (2 tiles) or corner (4 tiles).
    tile = np.broadcast_to([0.25, 0.25, 0.5], (N, 1, 3)).copy()
    size = rng.uniform(0.05, 0.2, (N, 1, 3))
    p1 = np.zeros((N, 3))
    p1[:, 2] = -0.5
    if name == "box_flat_on_box":
      xy = rng.uniform(-0.1, 0.1, (N, 2))
    else:
      xy = 0.25 * rng.choice([-1.0, 1.0], (N, 2))
      xy[::2, 1] = rng.uniform(-0.1, 0.1, N // 2)  # on an edge: 2 tiles
      xy += rng.choice([0.0, 0.01], (N, 2))
    p2 = np.concatenate([xy, size[:, 0, 2:] - rng.uniform(0.0, 0.01, (N, 1))], -1)
    return "box", "box", tile, size, 0.0, 0.0, 4, BOTH, p1, np.broadcast_to(
      np.eye(3), (N, 3, 3)).copy(), p2, _yaw(rng, N, quarter=True)
  if name == "separated":
    p1, p2 = near(0.6)
    return "box", "foot", box1, 1.0, 0.0, 0.0, 4, BOTH, p1, rot(), p2, rot()
  if name == "deep":
    p1 = rng.normal(0, 0.1, (N, 3))
    p2 = p1 + rng.normal(0, 0.01, (N, 3))
    return "box", "box", box1, rng.uniform(0.05, 0.3, (N, 1, 3)), 0.0, 0.0, 4, BOTH, \
      p1, rot(), p2, rot()
  raise ValueError(name)


CASES = ("box_box", "box_foot", "foot_foot", "sphere_foot", "capsule_foot", "box_cylinder",
         "cylinder_cylinder", "box_flat_on_box", "box_straddling_tiles", "separated", "deep")


def _tied_positions(p1, m1, v1, p2, m2, v2, r1, r2, normal) -> np.ndarray:
  """The contact positions of the midpoint fallback for every choice among
  tied support points along the axis (`normal`, world): hull 1's highest
  and hull 2's lowest vertices within 1e-12 of the support planes."""
  a = m1.T @ normal
  w2 = v2 @ (m1.T @ m2).T + m1.T @ (p2 - p1)
  d1, d2 = v1 @ a, w2 @ a
  h1, h2 = d1.max(), d2.min()
  if len(v1) == 1:  # a point hull contacts at its centre
    mids = v1
  else:
    mids = 0.5 * (v1[d1 >= h1 - 1e-12][:, None] + w2[d2 <= h2 + 1e-12][None])
    mids = mids.reshape(-1, 3)
  midplane = 0.5 * (h1 + r1 + h2 - r2)
  local = mids - (mids @ a - midplane)[:, None] * a
  return p1 + local @ m1.T


def check_against_jax(got, want, inputs) -> int:
  """dist and frame at TOL everywhere; positions at TOL except where the
  JAX package's contact is the midpoint fallback of tied supports (one
  finite slot), where both positions must be among the tied midpoints.
  Returns the number of such pairs. `inputs` gives each pair's (p1, m1,
  v1, p2, m2, v2, r1, r2) as numpy arrays."""
  (gd, gp, gf), (wd, wp, wf) = [[np.asarray(x) for x in t] for t in (got, want)]
  tp.close_elementwise(gd, wd, "dist")
  tp.close_elementwise(gf, wf, "frame")
  rows = np.nonzero((np.abs(gp - wp) > TOL * np.maximum(1.0, np.abs(wp))).any(axis=(-1, -2)))[0]
  for i in rows:
    assert (wd[i] < 1e9).sum() == 1 and np.array_equal(gp[i, 1:], wp[i, 1:]), (
      f"pair {i}: positions differ beyond the midpoint fallback")
    alt = _tied_positions(*(x[i] for x in inputs), wf[i, 0, 0])
    assert len(alt) > 1, f"pair {i}: positions differ with no tie"
    for pos in (gp[i, 0], wp[i, 0]):
      assert np.min(np.abs(alt - pos).max(-1)) <= TOL, f"pair {i}: not a tied midpoint"
  return len(rows)


@pytest.mark.parametrize("case", CASES)
def test_convex_convex_matches_jax(case):
  rng = np.random.default_rng(CASES.index(case))
  n1, n2, sc1, sc2, r1, r2, ncon, flags, p1, m1, p2, m2 = _case(case, rng)
  h = _hulls()
  h1, h2 = h[n1], h[n2]
  v1 = np.broadcast_to(h1.verts[None] * sc1, (N,) + h1.verts.shape).copy()
  v2 = np.broadcast_to(h2.verts[None] * sc2, (N,) + h2.verts.shape).copy()
  r1 = np.broadcast_to(np.asarray(r1, dtype=np.float64), (N,)).copy()
  r2 = np.broadcast_to(np.asarray(r2, dtype=np.float64), (N,)).copy()

  def one(p1, m1, v1, r1, p2, m2, v2, r2):
    return jc.convex_convex(
      p1, m1, v1, h1.face_verts, jnp.asarray(h1.face_normals), jnp.asarray(h1.edge_dirs),
      p2, m2, v2, h2.face_verts, jnp.asarray(h2.face_normals), jnp.asarray(h2.edge_dirs),
      r1=r1, r2=r2, ncon=ncon, **flags,
    )

  want = jax.jit(jax.vmap(one))(p1, m1, v1, r1, p2, m2, v2, r2)
  T = torch.as_tensor
  got = tc.convex_convex(
    T(p1), T(m1), T(v1), T(h1.face_verts), T(h1.face_normals), T(h1.edge_dirs),
    T(p2), T(m2), T(v2), T(h2.face_verts), T(h2.face_normals), T(h2.edge_dirs),
    r1=T(r1), r2=T(r2), ncon=ncon, **flags,
  )
  assert got[0].shape == (N, ncon) and got[2].shape == (N, ncon, 3, 3)
  tied = check_against_jax([x.numpy() for x in got], want, (p1, m1, v1, p2, m2, v2, r1, r2))
  dist = np.asarray(want[0])
  touching = (dist < 0).any(-1).sum()
  if case in ("box_flat_on_box", "box_straddling_tiles", "deep"):
    assert touching == N and tied == 0
  else:
    assert 0 < touching < N  # both contact and separation
  if case == "box_flat_on_box":
    # A resting box keeps its 4 bottom corners, at 4 distinct positions.
    assert (dist < 0).sum(-1).min() == 4
  if case == "box_straddling_tiles":
    # The contacts are the corners of the part over this tile: each pair has
    # one on the tile's edge (a clipped point), and none off the tile.
    xy = np.abs(np.asarray(want[1])[..., :2])
    on_tile = np.where((dist < 0)[..., None], xy, 0.0)
    assert on_tile.max() <= 0.25 + 1e-9
    assert (np.abs(on_tile - 0.25) < 1e-9).any(axis=(-1, -2)).all()


# ---------------------------------------------------------------------------
# The static convex pairs of a scene through `collision`.
# ---------------------------------------------------------------------------

_CLOUD = np.random.default_rng(7).normal(size=(24, 3)) * [0.1, 0.06, 0.04]

CONVEX_XML = f"""
<mujoco>
  <option integrator="implicitfast"/>
  <asset><mesh name="cloud" vertex="{' '.join(f'{x:.6f}' for x in _CLOUD.ravel())}"/></asset>
  <default><geom contype="2" conaffinity="2" friction="0.8 0.01 0.001"/></default>
  <worldbody>
    <geom type="plane" size="5 5 0.1" contype="1" conaffinity="1"/>
    <body name="a" pos="0 0 0.5"><freejoint/><geom type="box" size="0.1 0.07 0.05"/></body>
    <body name="b" pos="0.1 0 0.5"><freejoint/>
      <geom type="box" size="0.06 0.08 0.04" condim="1" priority="1" solref="0.01 1"/></body>
    <body name="m" pos="0 0.1 0.5"><freejoint/><geom type="mesh" mesh="cloud" solmix="2"/></body>
    <body name="s" pos="0 -0.1 0.5"><freejoint/><geom type="sphere" size="0.05"/></body>
    <body name="c" pos="-0.1 0 0.5"><freejoint/><geom type="capsule" size="0.03 0.08"/></body>
    <body name="y" pos="-0.1 0.1 0.5"><freejoint/><geom type="cylinder" size="0.05 0.04"/></body>
  </worldbody>
</mujoco>"""


@functools.lru_cache(maxsize=None)
def _convex_scene():
  mj = mujoco.MjModel.from_xml_string(CONVEX_XML)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  return mj, jtp, jm, ttp, tm


def test_convex_pairs_and_hulls_equal_jax():
  """Every pair of six free convex shapes (the cylinder as a tessellated
  hull; nothing touches the plane, whose contype differs): the pairs, their
  groups and the hulls, as the JAX package's."""
  _, jtp, _, ttp, _ = _convex_scene()
  keys = [(p.type1, p.type2) for p in ttp.pairs]
  assert [(p.geom1, p.geom2, p.type1, p.type2, p.ncon, p.condim) for p in ttp.pairs] == [
    (p.geom1, p.geom2, p.type1, p.type2, p.ncon, p.condim) for p in jtp.pairs]
  M, B, S, C = _G.mjGEOM_MESH, _G.mjGEOM_BOX, _G.mjGEOM_SPHERE, _G.mjGEOM_CAPSULE
  assert {k: keys.count(k) for k in set(keys)} == {
    (B, B): 1, (B, M): 4, (M, M): 1, (S, M): 2, (C, M): 2, (S, B): 2, (C, B): 2, (S, C): 1}
  assert sorted(ttp.geom_hulls) == sorted(jtp.geom_hulls) == [3, 6]
  for g, h in jtp.geom_hulls.items():
    for f in ("verts", "face_verts", "face_normals", "edge_dirs"):
      assert np.array_equal(getattr(ttp.geom_hulls[g], f), getattr(h, f)), (g, f)
  assert (ttp.ncon_max, ttp.nefc) == (jtp.ncon_max, jtp.nefc)


def _side_arrays(jtp, mj, g: int):
  """(verts, radius) of a geom as the JAX package's _convex_side makes them."""
  t, size = int(mj.geom_type[g]), mj.geom_size[g]
  if t == _G.mjGEOM_BOX:
    return jc.BOX_HULL.verts * size, 0.0
  if t == _G.mjGEOM_SPHERE:
    return np.zeros((1, 3)), size[0]
  if t == _G.mjGEOM_CAPSULE:
    return jc.CAPSULE_HULL.verts * size[1], size[0]
  return jtp.geom_hulls[g].verts, 0.0


def test_collision_of_the_convex_pairs_matches_jax():
  mj, jtp, jm, ttp, tm = _convex_scene()
  n = 96
  rng = np.random.default_rng(3)
  qpos = np.tile(mj.qpos0, (n, 1))
  for b in range(6):
    qpos[:, 7 * b : 7 * b + 3] = rng.normal(0.0, 0.06, (n, 3)) + [0.0, 0.0, 0.5]
    qpos[:, 7 * b + 3 : 7 * b + 7] = Rotation.random(n, random_state=rng).as_quat()[:, [3, 0, 1, 2]]
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
  d = jax.jit(jax.vmap(lambda d: jkinematics(jtp, jm, d)))(d.replace(qpos=jnp.asarray(qpos)))
  want = jax.jit(jax.vmap(lambda d: jcoll.collision(jtp, jm, d)))(d)
  got = tcoll.collision(ttp, tm, tp.to_torch(tp.jax_data_arrays(d)))
  for f in ("includemargin", "friction", "solref", "solimp", "solreffriction"):
    tp.close_elementwise(getattr(got.contact, f).numpy(), getattr(want.contact, f), f)
  xpos, xmat = np.asarray(d.geom_xpos), np.asarray(d.geom_xmat)
  start, tied = 0, 0
  for p in ttp.pairs:
    sl = slice(start, start + p.ncon)
    start += p.ncon
    parts = [(getattr(c.contact, f)[:, sl]) for c in (got, want)
             for f in ("dist", "pos", "frame")]
    if (p.type1, p.type2) not in tcoll._CONVEX_KEYS:
      for g, w, f in zip(parts[:3], parts[3:], ("dist", "pos", "frame")):
        tp.close_elementwise(np.asarray(g), w, f"{(p.type1, p.type2)} {f}")
      continue
    (v1, r1), (v2, r2) = _side_arrays(jtp, mj, p.geom1), _side_arrays(jtp, mj, p.geom2)
    inputs = (xpos[:, p.geom1], xmat[:, p.geom1], np.broadcast_to(v1, (n,) + v1.shape),
              xpos[:, p.geom2], xmat[:, p.geom2], np.broadcast_to(v2, (n,) + v2.shape),
              np.full(n, r1), np.full(n, r2))
    tied += check_against_jax([x.numpy() for x in parts[:3]], parts[3:], inputs)
  assert start == ttp.ncon_max
  active = np.asarray(want.contact.dist) < np.asarray(want.contact.includemargin)
  assert active.any(axis=0).sum() > ttp.ncon_max // 2  # most slots see a contact
  assert tied < n * len(ttp.pairs) // 10


def test_convex_group_is_the_collision_dispatch():
  """collision's convex groups are _convex_group with the JAX package's
  modes: the sphere side unclipped with vertex axes, the capsule side's
  segment clipped, box and hull pairs clipped both ways with edge axes
  within the budget."""
  _, _, _, ttp, _ = _convex_scene()
  modes = {}
  for g in ttp.dev.coll.groups:
    if getattr(g.fn, "func", None) is tcoll._convex_group:
      k = (g.fn.keywords["side1"].type, g.fn.keywords["side2"].type)
      modes[k] = g.fn.keywords["flags"]
      assert g.fn.keywords["flags"] == jcoll._convex_flags(
        *k, g.fn.keywords["side1"].ed.shape[-2], g.fn.keywords["side2"].ed.shape[-2])
  assert set(modes) == {k for k in tcoll._CONVEX_KEYS}
  assert modes[(_G.mjGEOM_SPHERE, _G.mjGEOM_MESH)]["clip_mode"] == "none"
  assert modes[(_G.mjGEOM_CAPSULE, _G.mjGEOM_MESH)]["clip_mode"] == "1on2"
  assert modes[(_G.mjGEOM_BOX, _G.mjGEOM_BOX)]["use_edge_axes"]


# ---------------------------------------------------------------------------
# Box and hull geoms against a box terrain pool (`_terrain_group_contacts`).
# ---------------------------------------------------------------------------

TERRAIN_ROBOT_XML = """
    <body name="brick" pos="0 0 1"><freejoint/>
      <geom type="box" size="0.15 0.08 0.05" contype="2" conaffinity="1"/>
    </body>
    <body name="sole" pos="1 0 1"><freejoint/>
      <geom type="mesh" mesh="cloud" contype="2" conaffinity="1" priority="1"
            friction="0.6 0.005 0.0001"/>
    </body>
    <body name="can" pos="-1 0 1"><freejoint/>
      <geom type="cylinder" size="0.06 0.04" contype="2" conaffinity="1" condim="1"/>
    </body>"""


@functools.lru_cache(maxsize=None)
def _terrain_scene():
  """The stairs of tests/test_torch_terrain_collision.py (80 boxes: a pool)
  with a free box, a free mesh hull and a free cylinder (a tessellated
  hull), which collide with the terrain only."""
  from test_torch_terrain_collision import _terrain_xml

  cloud = f'<mesh name="cloud" vertex="{" ".join(f"{x:.6f}" for x in _CLOUD.ravel())}"/>'
  xml = _terrain_xml(TERRAIN_ROBOT_XML).replace("<asset>", "<asset>\n    " + cloud)
  mj = mujoco.MjModel.from_xml_string(xml)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  return mj, jtp, jm, ttp, tm


@functools.lru_cache(maxsize=None)
def _terrain_posed(n: int = 64, seed: int = 0):
  """The three bodies over seeded stair tiles, on seams and step corners,
  level (every third) or tilted, sinking up to 1 cm or hovering up to 3
  cm; the JAX package's Data after kinematics, and the same as the port's."""
  from test_torch_terrain_collision import NX, NY, RISE, TILE

  mj, jtp, jm, _, _ = _terrain_scene()
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  for adr, half_height in ((0, 0.05), (7, 0.03), (14, 0.06)):
    ix = rng.integers(1, NX - 1, n)
    x = (ix - NX / 2) * TILE + rng.choice([0.0, 0.02, TILE / 2], n)
    y = (rng.integers(1, NY - 1, n) - NY / 2) * TILE + rng.choice([0.0, 0.1, 0.25], n)
    top = np.maximum(RISE * (ix // 2), RISE * ((ix - 1) // 2))
    z = top + half_height - rng.uniform(-0.01, 0.03, n)
    qpos[:, adr : adr + 3] = np.stack([x, y, z], -1)
    euler = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.3, 0.3, n),
                      rng.uniform(-0.3, 0.3, n)], -1)
    euler[::3, 1:] = 0.0
    qpos[:, adr + 3 : adr + 7] = Rotation.from_euler("zyx", euler).as_quat()[:, [3, 0, 1, 2]]
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
  d = jax.jit(jax.vmap(lambda d: jkinematics(jtp, jm, d)))(d.replace(qpos=jnp.asarray(qpos)))
  return d, tp.to_torch(tp.jax_data_arrays(d))


def test_box_and_mesh_terrain_groups_equal_jax():
  _, jtp, _, ttp, _ = _terrain_scene()
  assert [(int(g.robot_type), g.robot_geoms.tolist()) for g in ttp.terrain_groups] == [
    (_G.mjGEOM_BOX, [80]), (_G.mjGEOM_MESH, [81, 82])]
  for got, want in zip(ttp.terrain_groups, jtp.terrain_groups, strict=True):
    for f in ("robot_type", "robot_geoms", "robot_rad", "cells", "grid_lo", "condim"):
      assert np.array_equal(getattr(got, f), getattr(want, f)), f
  assert not ttp.pairs and (ttp.ncon_max, ttp.nefc) == (jtp.ncon_max, jtp.nefc) == (18, 72)
  assert sorted(ttp.geom_hulls) == sorted(jtp.geom_hulls) == [81, 82]
  for g, h in jtp.geom_hulls.items():
    for f in ("verts", "face_verts", "face_normals", "edge_dirs"):
      assert np.array_equal(getattr(ttp.geom_hulls[g], f), getattr(h, f)), (g, f)
  mesh = ttp.dev.coll.terrain[1]
  assert mesh.flags == jcoll._convex_flags(_G.mjGEOM_BOX, _G.mjGEOM_MESH, 3,
                                           mesh.robot_side.ed.shape[-2])


@pytest.mark.parametrize("slots", [6, 3])
def test_box_and_mesh_terrain_group_contacts_match_jax(slots):
  """Each group's slots and dropped counts at its 6 slots and at 3: 16
  candidates per geom (4 boxes x 4 SAT contacts), so both drop active
  contacts on these poses."""
  _, jtp, jm, ttp, tm = _terrain_scene()
  jd, td = _terrain_posed()
  dropped = 0
  for jtg in jtp.terrain_groups:
    jtg = dataclasses.replace(jtg, slots=slots)
    want = jax.jit(jax.vmap(lambda d: jcoll._terrain_group_contacts(jtp, jm, d, jtg)))(jd)
    got = tcoll._terrain_group_contacts(
      tm, td, tcoll._terrain_tables(ttp, jtg, torch.float64, "cpu"))
    tp.check_terrain_slots([g.numpy() for g in got[:7]], [np.asarray(w) for w in want[:7]],
                        f"group {jtg.robot_type}")
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    assert got[7].dtype == torch.int32
    dropped += int(got[7].sum())
    assert (np.asarray(want[0]) < np.asarray(want[6])).any()  # active contacts
  assert dropped > 0


def test_collision_with_box_and_mesh_terrain_groups_matches_jax():
  _, jtp, jm, ttp, tm = _terrain_scene()
  jd, td = _terrain_posed()
  want = jax.jit(jax.vmap(lambda d: jcoll.collision(jtp, jm, d)))(jd)
  got = tcoll.collision(ttp, tm, td)
  tp.check_terrain_slots(tp.contact_parts(got.contact), tp.contact_parts(want.contact), "collision")
  np.testing.assert_array_equal(got.contact.solreffriction.numpy(),
                                np.asarray(want.contact.solreffriction))
  np.testing.assert_array_equal(got.ncon_dropped.numpy(), np.asarray(want.ncon_dropped))
  assert got.ncon_dropped.sum() > 0
  active = (got.contact.dist < got.contact.includemargin).sum(dim=1)
  assert (active > 0).float().mean() > 0.75, active
