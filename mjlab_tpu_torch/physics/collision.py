"""Collision: static pair table → fixed contact slots (port of
mjlab_tpu/physics/collision.py).

The pair list comes from io._candidate_pairs, sorted by geometry-type
combination. Each type group runs one batched narrowphase over (env, pair);
a slot is active when dist < includemargin. The port implements the
analytic pairs: plane–sphere, plane–capsule (2 contacts), plane–box (4),
plane–cylinder (4 rim points), plane–ellipsoid (1 support point),
sphere–sphere, sphere–capsule, sphere–box, capsule–capsule and capsule–box
(2); plane–mesh (4 contacts), where the mesh is its convex hull
(convex.py) and the 4 deepest hull vertices are the contacts; the convex
pairs (box–box, sphere–mesh, capsule–mesh, box–mesh and mesh–mesh,
`_CONVEX_KEYS`) through the hull SAT, `convex.convex_convex`; and a height
field against a sphere, capsule, box or mesh (`_hfield_group`: contacts
against the triangulated 2×2 cell block under the geom, 4 per pair).

After the static pairs come the terrain groups' slots (`TerrainGroup`): a
box terrain's pool against the robot's sphere, capsule, box and mesh geoms,
through a cell-hash broadphase, the sphere–box, capsule–box or SAT
narrowphase and a greedy deepest-first selection, in
`_terrain_group_contacts`.

The narrowphase functions take (B, n, ...) tensors (any leading shape that
broadcasts) and mirror the JAX package's single-pair functions operation by
operation, including their clamping order, branch conditions and the way
they break ties, so that contact points agree.
"""

from __future__ import annotations

import functools
import itertools
from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics import convex as cvx
from mjlab_tpu_torch.physics.types import (
  Contact,
  Data,
  Model,
  TerrainGroup,
  Topology,
  float_tensor,
  index_tensor,
  mjtGeom,
)

_G = mjtGeom


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(a, dim=-1)


_normal_frame = cvx._normal_frame_rows


def _sphere_sphere(p1, r1, p2, r2):
  delta = p2 - p1
  l = _norm(delta)
  n = delta / torch.clamp_min(l, 1e-12)[..., None]
  ez = torch.eye(3, dtype=p1.dtype, device=p1.device)[2]
  n = torch.where((l < 1e-9)[..., None], ez, n)
  dist = l - (r1 + r2)
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _closest_segment_point(a, b, p):
  ab = b - a
  t = _dot(p - a, ab) / torch.clamp_min(_dot(ab, ab), 1e-12)
  return a + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def _first_argmin3(x: torch.Tensor) -> torch.Tensor:
  """Index of the least of 3 values, the lowest index among equals (as
  jnp.argmin breaks ties: a centred point ties its faces)."""
  k = torch.where(x[..., 1] < x[..., 0], 1, 0)
  least = torch.minimum(x[..., 1], x[..., 0])
  return torch.where(x[..., 2] < least, 2, k)


_first_argmin = cvx._first_argmin


def _lowest_k(x: torch.Tensor, k: int) -> torch.Tensor:
  """Indices of the k least values along the last axis in ascending order,
  the lower index first among equals (jax.lax.top_k of -x; torch.topk
  promises no order among equals)."""
  return torch.sort(x, dim=-1, stable=True).indices[..., :k]


def _sphere_box_impl(p, r, box_pos, box_mat, box_size, from_above: bool = False):
  """Sphere (centre p, radius r) against a box: dist, the contact point and
  the normal pointing box → sphere. A centre inside the box leaves through
  its nearest face; with `from_above` (the declared divergence of
  SimulationCfg.capsule_terrain_from_above) through the opposite face
  where that one faces down, so that a centre past a thin slab's mid-plane
  leaves through the top."""
  local = (box_mat.transpose(-1, -2) @ (p - box_pos)[..., None])[..., 0]
  clamped = torch.minimum(torch.maximum(local, -box_size), box_size)
  delta = local - clamped
  outside_d = _norm(delta)
  inside = outside_d < 1e-9
  side = torch.sign(local)
  face_d = box_size - torch.abs(local)
  if from_above:
    down = box_mat[..., 2, :] * side < -0.5
    side = torch.where(down, -side, side)
    face_d = torch.where(down, box_size + torch.abs(local), face_d)
  k = _first_argmin3(face_d)
  face_k = torch.gather(face_d, -1, k[..., None])
  n_in_local = side * torch.nn.functional.one_hot(k, 3).to(p.dtype)
  surf_in = local + n_in_local * face_k
  n_out_local = delta / torch.clamp_min(outside_d, 1e-12)[..., None]
  n_local = torch.where(inside[..., None], n_in_local, n_out_local)
  surface_local = torch.where(inside[..., None], surf_in, clamped)
  dist = torch.where(inside, -face_k[..., 0], outside_d) - r
  n_world = (box_mat @ n_local[..., None])[..., 0]
  surface_world = box_pos + (box_mat @ surface_local[..., None])[..., 0]
  pos = surface_world + n_world * (0.5 * dist)[..., None]
  return dist, pos, n_world


def _closest_segment_segment(a0, a1, b0, b1):
  """Closest points of two segments; the clamping order is the JAX
  package's (s, then t from s, then s again from t)."""
  da = a1 - a0
  db = b1 - b0
  r = a0 - b0
  A = _dot(da, da)
  B = _dot(da, db)
  C = _dot(db, db)
  D = _dot(da, r)
  E = _dot(db, r)
  denom = A * C - B * B
  s = torch.where(
    denom > 1e-12, (B * E - C * D) / torch.clamp_min(denom, 1e-12),
    torch.zeros_like(denom),
  )
  s = torch.clamp(s, 0.0, 1.0)
  t = torch.clamp((B * s + E) / torch.clamp_min(C, 1e-12), 0.0, 1.0)
  s = torch.clamp((B * t - D) / torch.clamp_min(A, 1e-12), 0.0, 1.0)
  return a0 + s[..., None] * da, b0 + t[..., None] * db


# ---------------------------------------------------------------------------
# Batched pair narrowphase: (p1, m1, s1, p2, m2, s2) of shapes (B, n, 3),
# (B, n, 3, 3), (n, 3) → dist (B, n, k), pos (B, n, k, 3), frame (B, n, k,
# 3, 3); the normal points geom1 → geom2.
# ---------------------------------------------------------------------------


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  dist = _dot(n, p2 - p1) - s2[:, 0]
  pos = p2 - n * (s2[:, 0] + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], _normal_frame(n)[..., None, :, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  axis = m2[..., :, 2]
  r, hl = s2[:, 0], s2[:, 1]
  frame = _normal_frame(n)
  ends = torch.stack(
    [p2 + axis * hl[:, None], p2 - axis * hl[:, None]], dim=-2
  )  # (B, n, 2, 3)
  dist = _dot(ends, n[..., None, :]) - _dot(n, p1)[..., None] - r[:, None]
  pos = ends - n[..., None, :] * (r[:, None] + 0.5 * dist)[..., None]
  return dist, pos, torch.stack([frame, frame], dim=-3)


def _box_corners(size: torch.Tensor) -> torch.Tensor:
  """The 8 corners (..., 8, 3) of boxes of half-sizes `size` (..., 3), in
  the JAX package's order (x slowest, z fastest). Built on the device: a
  tensor literal would be a host-to-device copy on every step."""
  i = torch.arange(8, device=size.device)
  signs = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=-1) * 2 - 1
  return signs.to(size.dtype) * size[..., None, :]


def _plane_box(p1, m1, s1, p2, m2, s2):
  """Plane vs box: the 4 deepest of its 8 corners, the lower corner index
  first among equals (a level box puts 4 corners at one depth)."""
  n = m1[..., :, 2]
  world = p2[..., None, :] + _box_corners(s2) @ m2.transpose(-1, -2)  # (B, n, 8, 3)
  dist8 = (world @ n[..., None])[..., 0] - _dot(n, p1)[..., None]
  idx = _lowest_k(dist8, 4)
  dist = torch.gather(dist8, -1, idx)
  picked = torch.gather(world, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = picked - n[..., None, :] * (0.5 * dist)[..., None]
  frame = _normal_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


def _plane_cylinder(p1, m1, s1, p2, m2, s2):
  """Plane vs cylinder, approximate: the 4 rim points of the end caps
  nearest the plane."""
  n = m1[..., :, 2]
  r, hl = s2[:, 0, None], s2[:, 1, None]
  axis = m2[..., :, 2]
  proj = n - axis * _dot(n, axis)[..., None]
  pnorm = _norm(proj)
  radial = torch.where((pnorm > 1e-8)[..., None],
                       -proj / torch.clamp_min(pnorm, 1e-12)[..., None], m2[..., :, 0])
  offs = torch.stack([axis * hl + radial * r, axis * hl - radial * r,
                      -axis * hl + radial * r, -axis * hl - radial * r], dim=-2)
  pts = p2[..., None, :] + offs  # (B, n, 4, 3)
  dist = (pts @ n[..., None])[..., 0] - _dot(n, p1)[..., None]
  pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
  frame = _normal_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  """Plane vs ellipsoid: its support point along the plane's inward
  normal."""
  n = m1[..., :, 2]
  n_local = (m2.transpose(-1, -2) @ -n[..., None])[..., 0]
  v = s2 * s2 * n_local
  denom = torch.sqrt(_dot(n_local, v))
  sp = p2 + (m2 @ (v / torch.clamp_min(denom, 1e-12)[..., None])[..., None])[..., 0]
  dist = _dot(n, sp - p1)
  pos = sp - n * (0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], _normal_frame(n)[..., None, :, :]


def _sphere_box(p1, m1, s1, p2, m2, s2):
  dist, pos, n = _sphere_box_impl(p1, s1[..., 0], p2, m2, s2)
  # _sphere_box_impl's normal points box → sphere = geom2 → geom1: flip.
  return dist[..., None], pos[..., None, :], _normal_frame(-n)[..., None, :, :]


def _capsule_box_normals(p1, m1, s1, p2, m2, s2, from_above: bool = False):
  """Capsule vs box as two spheres: at the segment point nearest the box
  centre and at the segment end on that side. With `from_above` (the
  declared divergence of SimulationCfg.capsule_terrain_from_above) the
  second sphere is the deeper of the two ends, and a sphere inside the box
  never leaves through a face that faces down. Returns dist (..., 2), pos
  (..., 2, 3) and the normals (..., 2, 3) pointing box → capsule."""
  axis, r, hl = m1[..., :, 2], s1[..., 0], s1[..., 1, None]
  near = _closest_segment_point(p1 - axis * hl, p1 + axis * hl, p2)
  d0, q0, n0 = _sphere_box_impl(near, r, p2, m2, s2, from_above)
  if from_above:
    da, qa, na = _sphere_box_impl(p1 + axis * hl, r, p2, m2, s2, True)
    db, qb, nb = _sphere_box_impl(p1 - axis * hl, r, p2, m2, s2, True)
    a = da <= db
    d1, q1, n1 = torch.where(a, da, db), torch.where(a[..., None], qa, qb), torch.where(
      a[..., None], na, nb)
  else:
    t_end = torch.where(_dot(near - p1, axis) >= 0, 1.0, -1.0).to(p1.dtype)
    d1, q1, n1 = _sphere_box_impl(p1 + axis * (t_end[..., None] * hl), r, p2, m2, s2)
  return (torch.stack([d0, d1], dim=-1), torch.stack([q0, q1], dim=-2),
          torch.stack([n0, n1], dim=-2))


def _capsule_box(p1, m1, s1, p2, m2, s2):
  dist, pos, n = _capsule_box_normals(p1, m1, s1, p2, m2, s2)
  return dist, pos, _normal_frame(-n)  # the normal points capsule → box


def _sphere_sphere_pair(p1, m1, s1, p2, m2, s2):
  dist, pos, n = _sphere_sphere(p1, s1[:, 0], p2, s2[:, 0])
  return dist[..., None], pos[..., None, :], _normal_frame(n)[..., None, :, :]


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis, hl = m2[..., :, 2], s2[:, 1, None]
  seg_pt = _closest_segment_point(p2 - axis * hl, p2 + axis * hl, p1)
  dist, pos, n = _sphere_sphere(p1, s1[:, 0], seg_pt, s2[:, 0])
  return dist[..., None], pos[..., None, :], _normal_frame(n)[..., None, :, :]


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  a1, h1 = m1[..., :, 2], s1[:, 1, None]
  a2, h2 = m2[..., :, 2], s2[:, 1, None]
  pt1, pt2 = _closest_segment_segment(
    p1 - a1 * h1, p1 + a1 * h1, p2 - a2 * h2, p2 + a2 * h2
  )
  dist, pos, n = _sphere_sphere(pt1, s1[:, 0], pt2, s2[:, 0])
  return dist[..., None], pos[..., None, :], _normal_frame(n)[..., None, :, :]


def _plane_convex(p1, m1, s1, p2, m2, s2, verts):
  """Plane vs convex hull: the 4 deepest hull vertices (`verts` (n, V, 3),
  geom frame) are the contacts. Ties go to the lower vertex index, as
  jax.lax.top_k breaks them: a level sole puts many vertices at one depth,
  and torch.topk promises no order among equals."""
  n = m1[..., :, 2]
  world = p2[..., None, :] + verts @ m2.transpose(-1, -2)  # (B, n, V, 3)
  depth = (world @ n[..., None])[..., 0] - _dot(n, p1)[..., None]
  idx = torch.sort(depth, dim=-1, stable=True).indices[..., :4]
  dist = torch.gather(depth, -1, idx)
  picked = torch.gather(world, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = picked - n[..., None, :] * (0.5 * dist)[..., None]
  frame = _normal_frame(n)[..., None, :, :].expand(dist.shape + (3, 3))
  return dist, pos, frame


# ---------------------------------------------------------------------------
# Height fields: contacts against the triangulated 2×2 cell block under a
# point, in the height field's frame.
# ---------------------------------------------------------------------------


def _closest_triangle_point(a, b, c, p):
  """Closest point on triangles abc to points p (Ericson's method, the
  region tests applied in the JAX package's order)."""
  ab = b - a
  ac = c - a
  ap = p - a
  d1 = _dot(ab, ap)
  d2 = _dot(ac, ap)
  bp = p - b
  d3 = _dot(ab, bp)
  d4 = _dot(ac, bp)
  cp = p - c
  d5 = _dot(ab, cp)
  d6 = _dot(ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = torch.clamp_min(va + vb + vc, 1e-12)
  v = vb / denom
  w = vc / denom
  q = a + v[..., None] * ab + w[..., None] * ac  # interior
  unit = lambda x: torch.clamp(x, 0, 1)[..., None]  # noqa: E731
  q = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None],
                  a + unit(d1 / torch.clamp_min(d1 - d3, 1e-12)) * ab, q)
  q = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None],
                  a + unit(d2 / torch.clamp_min(d2 - d6, 1e-12)) * ac, q)
  t_bc = unit((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-12))
  q = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None],
                  b + t_bc * (c - b), q)
  q = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, q)
  q = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, q)
  q = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, q)
  return q


def _hfield_cell_triangles(data, adr, nx: int, ny: int, size, c):
  """The 8 triangles (..., 8, 3, 3) of the 2×2 cell block around points c
  (..., 3) in the height field's frame. `data` is the Model's raster
  (column-major over x), `adr` (...) each point's field's address in it and
  `size` (..., 4) its size, both broadcasting with c[..., 0]."""
  rx, ry, elev = size[..., 0], size[..., 1], size[..., 2]
  dx = 2 * rx / (nx - 1)
  dy = 2 * ry / (ny - 1)
  ix = torch.clamp(torch.floor((c[..., 0] + rx) / dx).to(torch.int64), 0, nx - 2)
  iy = torch.clamp(torch.floor((c[..., 1] + ry) / dy).to(torch.int64), 0, ny - 2)

  def vertex(i, j):
    i = torch.clamp(i, 0, nx - 1)
    j = torch.clamp(j, 0, ny - 1)
    z = data[adr + j * nx + i] * elev  # MuJoCo's raster: x along the columns
    return torch.stack([-rx + i.to(c.dtype) * dx, -ry + j.to(c.dtype) * dy, z], dim=-1)

  tris = []
  for cx, cy in ((ix, iy), (ix - 1, iy), (ix, iy - 1), (ix - 1, iy - 1)):
    cx = torch.clamp(cx, 0, nx - 2)
    cy = torch.clamp(cy, 0, ny - 2)
    v00, v10 = vertex(cx, cy), vertex(cx + 1, cy)
    v01, v11 = vertex(cx, cy + 1), vertex(cx + 1, cy + 1)
    tris.append(torch.stack([v00, v10, v11], dim=-2))
    tris.append(torch.stack([v00, v11, v01], dim=-2))
  return torch.stack(tris, dim=-3)


def _sphere_hfield_contacts(c, r, tris):
  """Spheres (centres c (..., 3), radii r broadcasting with c[..., 0])
  against their 8 triangles: the deepest 4 contacts, the lower triangle
  first among equals (jax.lax.top_k's order). Returns dist (..., 4), pos
  (..., 4, 3) and normals (..., 4, 3) in the height field's frame."""
  c = c[..., None, :]
  a, b, cc = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
  q = _closest_triangle_point(a, b, cc, c)
  delta = c - q
  dn = _norm(delta)
  n_tri = mt.cross(b - a, cc - a)
  n_tri = n_tri / torch.clamp_min(_norm(n_tri), 1e-12)[..., None]
  n_tri = torch.where((n_tri[..., 2] < 0)[..., None], -n_tri, n_tri)  # up-facing
  hn = _dot(n_tri, delta)
  # A penetration counts only where the closest point is the centre's
  # projection into this triangle: a centre below the raster lies below the
  # planes of its neighbours too, at a large lateral distance.
  lateral_sq = torch.sum((delta - hn[..., None] * n_tri) ** 2, dim=-1)
  below = (hn < 0) & (lateral_sq < 1e-12 + 1e-9 * dn * dn)
  n = torch.where((dn > 1e-9)[..., None], delta / torch.clamp_min(dn, 1e-12)[..., None], n_tri)
  n = torch.where(below[..., None], n_tri, n)
  dist = torch.where(below, -dn, dn) - r[..., None]
  pos = q + n * (0.5 * dist)[..., None]
  idx = _lowest_k(dist, 4)
  take = lambda x: torch.gather(x, -2, idx[..., None].expand(idx.shape + (3,)))  # noqa: E731
  return torch.gather(dist, -1, idx), take(pos), take(n)


def _hfield_group(m: Model, d: Data, g: SimpleNamespace):
  """A (height field, sphere | capsule | box | mesh) group's narrowphase,
  one sub-group per raster shape: a sphere against the cell block under its
  centre; a capsule as spheres at both ends, the deepest 2 contacts each;
  a box or a mesh hull's vertices as points against the surface under
  each, the deepest 4 vertices. Heights are read from the Model."""
  B = d.qpos.shape[0]
  n, k = g.g1.shape[0], g.k
  dtype = d.qpos.dtype
  dist = torch.empty((B, n, k), dtype=dtype, device=d.qpos.device)
  pos = torch.empty((B, n, k, 3), dtype=dtype, device=d.qpos.device)
  frame = torch.empty((B, n, k, 3, 3), dtype=dtype, device=d.qpos.device)
  for sub in g.hfield:
    p1, m1 = d.geom_xpos[:, sub.g1], d.geom_xmat[:, sub.g1]
    p2, m2 = d.geom_xpos[:, sub.g2], d.geom_xmat[:, sub.g2]
    s2 = m.geom_size[sub.g2]
    m1t = m1.transpose(-1, -2)
    c = (m1t @ (p2 - p1)[..., None])[..., 0]  # geom2's centre, field frame
    hsize = m.hfield_size[sub.hid]
    tri = functools.partial(_hfield_cell_triangles, m.hfield_data, nx=sub.nx, ny=sub.ny)
    if g.type2 == _G.mjGEOM_SPHERE:
      dl, pl, nl = _sphere_hfield_contacts(
        c, s2[:, 0], tri(adr=sub.adr, size=hsize, c=c))
    elif g.type2 == _G.mjGEOM_CAPSULE:
      axis = (m1t @ m2[..., :, 2, None])[..., 0]
      r, hl = s2[:, 0], s2[:, 1, None]
      outs = []
      for sgn in (1.0, -1.0):
        e = c + sgn * hl * axis
        de, pe, ne = _sphere_hfield_contacts(e, r, tri(adr=sub.adr, size=hsize, c=e))
        outs.append((de[..., :2], pe[..., :2, :], ne[..., :2, :]))
      dl, pl, nl = (torch.cat(x, dim=-2 if i else -1) for i, x in enumerate(zip(*outs)))
    else:  # box or mesh: the hull's vertices as points
      verts = sub.verts * s2[:, None, :] if g.type2 == _G.mjGEOM_BOX else sub.verts
      rm = m1t @ m2
      vl = verts @ rm.transpose(-1, -2) + c[..., None, :]  # (B, n, V, 3)
      zero = torch.zeros((), dtype=dtype, device=c.device)
      dv, pv, nv = _sphere_hfield_contacts(
        vl, zero, tri(adr=sub.adr[:, None], size=hsize[:, None], c=vl))
      dv, pv, nv = dv[..., 0], pv[..., 0, :], nv[..., 0, :]  # the deepest per vertex
      top = _lowest_k(dv, 4)
      take = lambda x: torch.gather(x, -2, top[..., None].expand(top.shape + (3,)))  # noqa: E731
      dl, pl, nl = torch.gather(dv, -1, top), take(pv), take(nv)
    dist[:, sub.rows] = dl
    pos[:, sub.rows] = p1[..., None, :] + pl @ m1t
    frame[:, sub.rows] = _normal_frame(nl @ m1t)
  return dist, pos, frame


def _hfield_tables(tp: Topology, key, g1: np.ndarray, g2: np.ndarray, dtype, device):
  """A height-field group's sub-groups, one per raster shape (ncol, nrow):
  their rows in the group, geom ids, fields' ids and raster addresses, and a
  box's unit hull or the mesh hulls' vertices padded to the sub-group's
  most."""
  by_shape: dict[tuple[int, int], list[int]] = {}
  for i, ga in enumerate(g1):
    hid = int(tp.geom_dataid[ga])
    by_shape.setdefault((int(tp.hfield_ncol[hid]), int(tp.hfield_nrow[hid])), []).append(i)
  subs = []
  for (nx, ny), rows in by_shape.items():
    gg1, gg2 = g1[rows], g2[rows]
    hid = tp.geom_dataid[gg1]
    if key[1] == _G.mjGEOM_MESH:
      verts = float_tensor(cvx.pad_hulls([tp.geom_hulls[int(g)] for g in gg2])[0],
                           dtype, device)
    elif key[1] == _G.mjGEOM_BOX:
      verts = float_tensor(cvx.BOX_HULL.verts, dtype, device)
    else:
      verts = None
    subs.append(SimpleNamespace(
      nx=nx, ny=ny, rows=index_tensor(rows, device), g1=index_tensor(gg1, device),
      g2=index_tensor(gg2, device), hid=index_tensor(hid, device),
      adr=index_tensor(tp.hfield_adr[hid], device), verts=verts,
    ))
  return subs


# ---------------------------------------------------------------------------
# Convex pairs (box–box and every pair with a mesh hull) through the SAT.
# ---------------------------------------------------------------------------

_CONVEX_KEYS = {
  (_G.mjGEOM_BOX, _G.mjGEOM_BOX),
  (_G.mjGEOM_SPHERE, _G.mjGEOM_MESH),
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_MESH),
  (_G.mjGEOM_BOX, _G.mjGEOM_MESH),
  (_G.mjGEOM_MESH, _G.mjGEOM_MESH),
}


def _convex_side_tables(tp: Topology, gids: np.ndarray, gtype: int, dtype,
                        device) -> SimpleNamespace:
  """One side of a convex pair group (or a terrain group's robot side), on
  the device: a mesh side's hulls padded to the group's most (pad_hulls); a
  box's, sphere's or capsule's unit hull, scaled by the geom size at run
  time (`_convex_side`)."""
  if gtype == _G.mjGEOM_MESH:
    arrays = cvx.pad_hulls([tp.geom_hulls[int(g)] for g in gids])
  else:
    h = {_G.mjGEOM_BOX: cvx.BOX_HULL, _G.mjGEOM_SPHERE: cvx.SPHERE_HULL,
         _G.mjGEOM_CAPSULE: cvx.CAPSULE_HULL}[gtype]
    arrays = (h.verts, h.face_verts, h.face_normals, h.edge_dirs)
  verts, fv, fn, ed = arrays
  return SimpleNamespace(
    type=gtype, verts=float_tensor(verts, dtype, device), fv=index_tensor(fv, device),
    fn=float_tensor(fn, dtype, device), ed=float_tensor(ed, dtype, device),
  )


def _convex_side(side: SimpleNamespace, size: torch.Tensor):
  """The side's hull data at run time from its geoms' sizes (n, 3): verts,
  face_verts, face_normals, edge_dirs and the inflation radius (n,) or 0."""
  if side.type == _G.mjGEOM_MESH:
    return side.verts, side.fv, side.fn, side.ed, 0.0
  if side.type == _G.mjGEOM_BOX:
    return side.verts * size[:, None, :], side.fv, side.fn, side.ed, 0.0
  if side.type == _G.mjGEOM_SPHERE:
    return side.verts, side.fv, side.fn, side.ed, size[:, 0]
  # A capsule: its z segment of half-length size[1], radius size[0].
  return side.verts * size[:, 1, None, None], side.fv, side.fn, side.ed, size[:, 0]


def _convex_flags(t1: int, t2: int, e1: int, e2: int) -> dict:
  """convex_convex's mode per pair-type combination (e1, e2: the sides'
  edge-direction counts)."""
  if t1 == _G.mjGEOM_SPHERE:
    return dict(use_edge_axes=False, vertex_axes=True, clip_mode="none")
  if t1 == _G.mjGEOM_CAPSULE:
    return dict(use_edge_axes=True, vertex_axes=True, clip_mode="1on2")
  return dict(use_edge_axes=e1 * e2 <= cvx.EDGE_AXIS_BUDGET, vertex_axes=False,
              clip_mode="both")


def _edge_count(side: SimpleNamespace) -> int:
  return side.ed.shape[-2]


def _convex_group(p1, m1, s1, p2, m2, s2, *, side1, side2, ncon: int, flags: dict):
  """A convex pair group's narrowphase: (B, n) pairs through convex_convex."""
  v1, fv1, fn1, ed1, r1 = _convex_side(side1, s1)
  v2, fv2, fn2, ed2, r2 = _convex_side(side2, s2)
  return cvx.convex_convex(p1, m1, v1, fv1, fn1, ed1, p2, m2, v2, fv2, fn2, ed2,
                           r1=r1, r2=r2, ncon=ncon, **flags)


_DISPATCH = {
  (_G.mjGEOM_PLANE, _G.mjGEOM_SPHERE): _plane_sphere,
  (_G.mjGEOM_PLANE, _G.mjGEOM_CAPSULE): _plane_capsule,
  (_G.mjGEOM_PLANE, _G.mjGEOM_CYLINDER): _plane_cylinder,
  (_G.mjGEOM_PLANE, _G.mjGEOM_ELLIPSOID): _plane_ellipsoid,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_SPHERE): _sphere_sphere_pair,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_CAPSULE): _sphere_capsule,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_CAPSULE): _capsule_capsule,
  (_G.mjGEOM_PLANE, _G.mjGEOM_MESH): _plane_convex,
  (_G.mjGEOM_PLANE, _G.mjGEOM_BOX): _plane_box,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_BOX): _sphere_box,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_BOX): _capsule_box,
}


def _hull_verts(tp: Topology, g2: np.ndarray, dtype, device) -> torch.Tensor:
  """The group's hull vertices (n, V, 3), each padded to the group's most
  by repeating its first vertex (the JAX package's padding)."""
  vs = [tp.geom_hulls[int(g)].verts for g in g2]
  vmax = max(v.shape[0] for v in vs)
  padded = [np.concatenate([v, np.broadcast_to(v[:1], (vmax - v.shape[0], 3))]) for v in vs]
  return torch.as_tensor(np.stack(padded), dtype=dtype, device=device)


def _terrain_tables(tp: Topology, tg: TerrainGroup, dtype, device) -> SimpleNamespace:
  """A terrain group's device tensors: its cell hash, grid corner, robot
  geoms and their radii, and the static priority picks of mj_contactParam
  (the pool's priority is uniform); for a box or mesh group, both sides'
  hull tables and the SAT's mode (the terrain box is geom1)."""
  prio = tp.geom_priority[tg.robot_geoms]
  t = SimpleNamespace(
    tg=tg,
    cells=index_tensor(tg.cells, device),
    grid_lo=float_tensor(tg.grid_lo, dtype, device),
    robot_geoms=index_tensor(tg.robot_geoms, device),
    robot_rad=float_tensor(tg.robot_rad, dtype, device),
    r_higher=torch.as_tensor(prio > tg.pool_priority, device=device),
    t_higher=torch.as_tensor(prio < tg.pool_priority, device=device),
    from_above=tp.capsule_terrain_from_above,
  )
  if tg.robot_type in (_G.mjGEOM_BOX, _G.mjGEOM_MESH):
    t.box_side = _convex_side_tables(tp, (), _G.mjGEOM_BOX, dtype, device)
    t.robot_side = _convex_side_tables(tp, tg.robot_geoms, tg.robot_type, dtype, device)
    t.flags = _convex_flags(_G.mjGEOM_BOX, tg.robot_type, _edge_count(t.box_side),
                            _edge_count(t.robot_side))
  return t


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  """Per type group: geom index tensors, contacts per pair, and the static
  priority selection of mj_contactParam; per terrain group its tables."""

  groups = []
  for key, group in itertools.groupby(tp.pairs, key=lambda p: (p.type1, p.type2)):
    group = list(group)
    g1 = np.asarray([p.geom1 for p in group])
    g2 = np.asarray([p.geom2 for p in group])
    prio1, prio2 = tp.geom_priority[g1], tp.geom_priority[g2]
    hfield = None
    if key[0] == _G.mjGEOM_HFIELD:
      fn, hfield = None, _hfield_tables(tp, key, g1, g2, dtype, device)
    elif key in _CONVEX_KEYS:
      side1 = _convex_side_tables(tp, g1, key[0], dtype, device)
      side2 = _convex_side_tables(tp, g2, key[1], dtype, device)
      fn = functools.partial(
        _convex_group, side1=side1, side2=side2, ncon=group[0].ncon,
        flags=_convex_flags(key[0], key[1], _edge_count(side1), _edge_count(side2)),
      )
    else:
      fn = _DISPATCH[key]
    if key == (_G.mjGEOM_PLANE, _G.mjGEOM_MESH):
      fn = functools.partial(fn, verts=_hull_verts(tp, g2, dtype, device))
    pair_id = np.asarray([p.pair_id for p in group])
    explicit = pair_id >= 0
    groups.append(
      SimpleNamespace(
        fn=fn, hfield=hfield, type2=key[1], k=group[0].ncon, g1=index_tensor(g1, device),
        g2=index_tensor(g2, device),
        hi=index_tensor(np.where(prio1 >= prio2, g1, g2), device),
        differ=torch.as_tensor(prio1 != prio2, device=device)[:, None],
        # Explicit <pair>s of the group: which rows, and their pair ids.
        pair=(torch.as_tensor(explicit, device=device)[:, None],
              index_tensor(np.where(explicit, pair_id, 0), device))
        if explicit.any() else None,
      )
    )
  return SimpleNamespace(
    groups=groups,
    terrain=[_terrain_tables(tp, tg, dtype, device) for tg in tp.terrain_groups],
  )


def _combine_params_vec(m: Model, g):
  """Vectorized mj_contactParam over a pair group (static priorities). A
  per-env `geom_friction` (B, ngeom, 3) gives a per-env friction (B, n, 5);
  every other result is shared by the batch. An explicit <pair> takes its
  friction, solref, solimp, margin and solreffriction verbatim from the
  `pair_*` leaves (mj_collision's predefined pairs)."""
  g1, g2, hi, differ = g.g1, g.g2, g.hi, g.differ
  fr = m.geom_friction
  if fr.dim() == 3:
    fr = fr.transpose(0, 1)  # (ngeom, B, 3): index geoms first
    differ = differ[..., None]
  s1 = torch.clamp_min(m.geom_solmix[g1], 1e-12)
  s2 = torch.clamp_min(m.geom_solmix[g2], 1e-12)
  w1 = (s1 / (s1 + s2))[:, None]
  w2 = (s2 / (s1 + s2))[:, None]
  fri_mix = torch.maximum(fr[g1], fr[g2])
  ref1, ref2 = m.geom_solref[g1], m.geom_solref[g2]
  ref_mix = w1 * ref1 + w2 * ref2
  direct = ((ref1[:, 0] <= 0) | (ref2[:, 0] <= 0))[:, None]
  ref_mix = torch.where(direct, torch.minimum(ref1, ref2), ref_mix)
  imp_mix = w1 * m.geom_solimp[g1] + w2 * m.geom_solimp[g2]
  fri3 = torch.where(differ, fr[hi], fri_mix)
  solref = torch.where(g.differ, m.geom_solref[hi], ref_mix)
  solimp = torch.where(g.differ, m.geom_solimp[hi], imp_mix)
  margin = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
  friction = torch.stack(
    [fri3[..., 0], fri3[..., 0], fri3[..., 1], fri3[..., 2], fri3[..., 2]], dim=-1
  )
  if friction.dim() == 3:
    friction = friction.transpose(0, 1)  # (B, n, 5)
  # includemargin = margin (MuJoCo >= 3.10 ignores gap).
  solreffriction = torch.zeros_like(solref)  # zeros: friction rows use solref
  if g.pair is not None:
    sel, pid = g.pair
    friction = torch.where(sel, m.pair_friction[pid], friction)
    solref = torch.where(sel, m.pair_solref[pid], solref)
    solimp = torch.where(sel, m.pair_solimp[pid], solimp)
    margin = torch.where(sel[:, 0], m.pair_margin[pid], margin)
    solreffriction = torch.where(sel, m.pair_solreffriction[pid], solreffriction)
  return friction, solref, solimp, margin, solreffriction


def _gather_envs(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """x (B, ngeom, ...) at per-env geom ids (B, ...) → (B, ..., ...)."""
  B = x.shape[0]
  b = torch.arange(B, device=x.device).view((B,) + (1,) * (ids.dim() - 1))
  return x[b, ids]


def _combine_params_terrain(m: Model, t: SimpleNamespace, ids: torch.Tensor):
  """mj_contactParam for (robot geom, selected terrain geom) with the
  terrain side gathered at the broadphase's ids (B, R, K). The priority
  comparison is static (the pool's priority is uniform). Returns friction
  (B, R, K, 5), solref (B, R, K, 2), solimp (B, R, K, 5) and the margin
  (B, R, K)."""
  g = t.robot_geoms
  fr = m.geom_friction
  if fr.dim() == 3:  # per-env friction (B, ngeom, 3)
    fri_r, fri_t = fr[:, g][:, :, None], _gather_envs(fr, ids)
  else:
    fri_r, fri_t = fr[g][:, None], fr[ids]
  ref_r, imp_r = m.geom_solref[g][:, None], m.geom_solimp[g][:, None]
  ref_t, imp_t = m.geom_solref[ids], m.geom_solimp[ids]
  s_r = torch.clamp_min(m.geom_solmix[g], 1e-12)[:, None]
  s_t = torch.clamp_min(m.geom_solmix[ids], 1e-12)
  w_r = (s_r / (s_r + s_t))[..., None]
  w_t = 1.0 - w_r
  fri_mix = torch.maximum(fri_r, fri_t)
  ref_mix = w_r * ref_r + w_t * ref_t
  direct = ((ref_r[..., 0] <= 0) | (ref_t[..., 0] <= 0))[..., None]
  ref_mix = torch.where(direct, torch.minimum(ref_r, ref_t), ref_mix)
  imp_mix = w_r * imp_r + w_t * imp_t
  r_hi, t_hi = t.r_higher[:, None, None], t.t_higher[:, None, None]

  def pick(a_r, a_t, a_mix):
    return torch.where(r_hi, a_r.expand(a_t.shape), torch.where(t_hi, a_t, a_mix))

  fri3 = pick(fri_r, fri_t, fri_mix)
  solref = pick(ref_r, ref_t, ref_mix)
  solimp = pick(imp_r, imp_t, imp_mix)
  margin = torch.maximum(m.geom_margin[g][:, None], m.geom_margin[ids])
  friction = torch.stack(
    [fri3[..., 0], fri3[..., 0], fri3[..., 1], fri3[..., 2], fri3[..., 2]], dim=-1
  )
  return friction, solref, solimp, margin


def _terrain_group_contacts(m: Model, d: Data, t: SimpleNamespace):
  """Broadphase (cell hash, then the K nearest by bounding sphere),
  narrowphase and slot selection of one terrain group (port of the JAX
  package's `_terrain_group_contacts`).

  Returns (B, R·slots) slots in robot-geom order — dist, pos, frame,
  friction, solref, solimp, includemargin — and each env's count of
  dropped contacts: active candidates neither selected nor within the
  dedupe radius of a selected one, i.e. contact points lost to the slot
  capacity."""
  tg = t.tg
  rg = t.robot_geoms
  B = d.qpos.shape[0]
  R, K, S = len(tg.robot_geoms), tg.ncand, tg.slots
  ncx, ncy, _ = tg.cells.shape
  p = d.geom_xpos[:, rg]  # (B, R, 3)
  ix = torch.floor((p[..., 0] - t.grid_lo[0]) / tg.cell_size).long().clamp(0, ncx - 1)
  iy = torch.floor((p[..., 1] - t.grid_lo[1]) / tg.cell_size).long().clamp(0, ncy - 1)
  cand = t.cells[ix, iy]  # (B, R, L) geom ids, -1 padded
  valid = cand >= 0
  cid = torch.clamp_min(cand, 0)
  bpos = _gather_envs(d.geom_xpos, cid)  # (B, R, L, 3)
  brad = _norm(m.geom_size[cid])
  key = torch.sum((p[:, :, None] - bpos) ** 2, dim=-1) - (brad + t.robot_rad[:, None]) ** 2
  key = torch.where(valid, key, torch.inf)
  topi = _lowest_k(key, K)
  ids = torch.gather(cid, -1, topi)  # (B, R, K)
  ok = torch.gather(valid, -1, topi)

  bp = _gather_envs(d.geom_xpos, ids)  # (B, R, K, 3)
  bm = _gather_envs(d.geom_xmat, ids)
  bs = m.geom_size[ids]
  rp, rm, rs = p[:, :, None], d.geom_xmat[:, rg][:, :, None], m.geom_size[rg][:, None]

  # Slot convention: the terrain geom is geom1 (welded to the world), the
  # robot geom geom2; the frame normals point terrain → robot.
  if tg.robot_type == _G.mjGEOM_SPHERE:
    dist, pos, n = _sphere_box_impl(rp, rs[..., 0], bp, bm, bs)
    dist, pos, frame = dist[..., None], pos[..., None, :], _normal_frame(n[..., None, :])
  elif tg.robot_type == _G.mjGEOM_CAPSULE:
    dist, pos, n = _capsule_box_normals(rp, rm, rs, bp, bm, bs, t.from_above)
    frame = _normal_frame(n)
  else:
    # A robot box or hull (geom2) against each candidate box (geom1): the
    # SAT with 4 contacts per candidate.
    def per_geom(x):  # (R, ...) hull data → (R, 1, ...): broadcast over K
      return x[:, None] if x.dim() == 3 else x

    robot = [per_geom(x) for x in _convex_side(t.robot_side, m.geom_size[rg])[:4]]
    box = t.box_side
    dist, pos, frame = cvx.convex_convex(
      bp, bm, box.verts * bs[..., None, :], box.fv, box.fn, box.ed,
      rp, rm, *robot,
      ncon=4, **t.flags,
    )

  # (B, R, K, k) candidates → keep S per robot geom, deepest first, each
  # pick suppressing the candidates within rho of it laterally: on a tile
  # seam plain depth top-k fills every slot with near-coincident corners of
  # adjacent tiles, the support polygon collapses and the body rocks.
  k = dist.shape[-1]
  nc = K * k
  dist = torch.where(ok[..., None], dist, 1e10).reshape(B, R, nc)
  pos = pos.reshape(B, R, nc, 3)
  frame = frame.reshape(B, R, nc, 3, 3)
  xy = pos[..., :2]
  rho2 = (0.3 * t.robot_rad[:, None]) ** 2  # (R, 1)
  arange = torch.arange(nc, device=dist.device)
  taken = torch.zeros_like(dist, dtype=torch.bool)
  sels = []
  for _ in range(S):
    j = _first_argmin(torch.where(taken, torch.inf, dist))  # (B, R)
    sels.append(j)
    xy_j = torch.gather(xy, 2, j[..., None, None].expand(B, R, 1, 2))
    close = torch.sum((xy - xy_j) ** 2, dim=-1) < rho2
    taken = taken | close | (arange == j[..., None])
  sel = torch.stack(sels, dim=-1)  # (B, R, S)

  friction, solref, solimp, inclm = _combine_params_terrain(m, t, ids)

  def expand(a):  # (B, R, K, ...) → (B, R, K·k, ...)
    return torch.repeat_interleave(a, k, dim=2)

  # The dropped-contact count (the JAX package's saturation telemetry).
  active = dist < expand(inclm)
  sel_xy = torch.gather(xy, 2, sel[..., None].expand(B, R, S, 2))
  d2 = torch.sum((xy[:, :, :, None] - sel_xy[:, :, None]) ** 2, dim=-1)  # (B, R, nc, S)
  near_sel = torch.any(d2 < rho2[..., None], dim=-1)
  is_sel = torch.any(arange[:, None] == sel[:, :, None], dim=-1)
  dropped = torch.sum(active & ~near_sel & ~is_sel, dim=(1, 2), dtype=torch.int32)

  def take(a):  # (B, R, nc, ...) at the selected slots → (B, R·S, ...)
    idx = sel.view(B, R, S, *([1] * (a.dim() - 3))).expand(B, R, S, *a.shape[3:])
    return torch.gather(a, 2, idx).reshape(B, R * S, *a.shape[3:])

  return (take(dist), take(pos), take(frame), take(expand(friction)),
          take(expand(solref)), take(expand(solimp)), take(expand(inclm)), dropped)


def collision(tp: Topology, m: Model, d: Data) -> Data:
  """One batched narrowphase call per type group, then the terrain groups'
  slots, concatenated in slot order (constraint.slot_tables' order)."""
  B = d.qpos.shape[0]
  if tp.ncon_max == 0:
    return d.replace(ncon_dropped=torch.zeros_like(d.ncon_dropped))
  parts: dict[str, list[torch.Tensor]] = {
    f: [] for f in ("dist", "pos", "frame", "friction", "solref", "solimp",
                    "includemargin", "solreffriction")
  }
  for g in tp.dev.coll.groups:
    if g.hfield is not None:
      dist, pos, frame = _hfield_group(m, d, g)
    else:
      dist, pos, frame = g.fn(
        d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1], m.geom_size[g.g1],
        d.geom_xpos[:, g.g2], d.geom_xmat[:, g.g2], m.geom_size[g.g2],
      )
    n = g.g1.shape[0]
    parts["dist"].append(dist.reshape(B, n * g.k))
    parts["pos"].append(pos.reshape(B, n * g.k, 3))
    parts["frame"].append(frame.reshape(B, n * g.k, 3, 3))
    friction, solref, solimp, margin, sreff = _combine_params_vec(m, g)
    for f, v in (("friction", friction), ("solref", solref), ("solimp", solimp),
                 ("includemargin", margin), ("solreffriction", sreff)):
      if f == "friction" and v.dim() == 3:  # per-env friction (B, n, 5)
        parts[f].append(torch.repeat_interleave(v, g.k, dim=1))
        continue
      v = torch.repeat_interleave(v, g.k, dim=0)
      parts[f].append(v.expand((B,) + v.shape))
  ncon_dropped = torch.zeros_like(d.ncon_dropped)
  for t in tp.dev.coll.terrain:
    *slots, dropped = _terrain_group_contacts(m, d, t)
    ncon_dropped = ncon_dropped + dropped
    for f, v in zip(("dist", "pos", "frame", "friction", "solref", "solimp",
                     "includemargin"), slots):
      parts[f].append(v)
    parts["solreffriction"].append(torch.zeros_like(slots[4]))  # no <pair> into pools
  contact = Contact(**{f: torch.cat(v, dim=1) for f, v in parts.items()})
  return d.replace(contact=contact, ncon_dropped=ncon_dropped)
