"""Collision: static pair table → fixed contact slots (port of
mjlab_tpu/physics/collision.py).

The pair list comes from io._candidate_pairs, sorted by geometry-type
combination. Each type group runs one batched narrowphase over (env, pair);
a slot is active when dist < includemargin. The port implements the
analytic pairs: plane–sphere, plane–capsule (2 contacts), sphere–sphere,
sphere–capsule and capsule–capsule; and plane–mesh (4 contacts), where the
mesh is its convex hull (convex.py) and the 4 deepest hull vertices are the
contacts.

The narrowphase functions take (B, n, ...) tensors and mirror the JAX
package's single-pair functions operation by operation, including their
clamping order and branch conditions, so that contact points agree.
"""

from __future__ import annotations

import functools
import itertools
from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics.types import (
  Contact,
  Data,
  Model,
  Topology,
  index_tensor,
  mjtGeom,
)

_G = mjtGeom


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.sum(a * b, dim=-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(a, dim=-1)


def _normal_frame(n: torch.Tensor) -> torch.Tensor:
  """Right-handed frames (..., 3, 3) with rows [n, t1, t2] from unit normals."""
  # torch.eye fills on the device; a torch.tensor literal would be a
  # host-to-device copy, and a stream sync, on every step.
  eye = torch.eye(3, dtype=n.dtype, device=n.device)
  ref = torch.where((torch.abs(n[..., 0]) < 0.5)[..., None], eye[0], eye[1])
  t1 = mt.cross(n, ref)
  t1 = t1 / torch.clamp_min(_norm(t1), 1e-12)[..., None]
  t2 = mt.cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


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


_DISPATCH = {
  (_G.mjGEOM_PLANE, _G.mjGEOM_SPHERE): _plane_sphere,
  (_G.mjGEOM_PLANE, _G.mjGEOM_CAPSULE): _plane_capsule,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_SPHERE): _sphere_sphere_pair,
  (_G.mjGEOM_SPHERE, _G.mjGEOM_CAPSULE): _sphere_capsule,
  (_G.mjGEOM_CAPSULE, _G.mjGEOM_CAPSULE): _capsule_capsule,
  (_G.mjGEOM_PLANE, _G.mjGEOM_MESH): _plane_convex,
}


def _hull_verts(tp: Topology, g2: np.ndarray, dtype, device) -> torch.Tensor:
  """The group's hull vertices (n, V, 3), each padded to the group's most
  by repeating its first vertex (the JAX package's padding)."""
  vs = [tp.geom_hulls[int(g)].verts for g in g2]
  vmax = max(v.shape[0] for v in vs)
  padded = [np.concatenate([v, np.broadcast_to(v[:1], (vmax - v.shape[0], 3))]) for v in vs]
  return torch.as_tensor(np.stack(padded), dtype=dtype, device=device)


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  """Per type group: geom index tensors, contacts per pair, and the static
  priority selection of mj_contactParam."""

  groups = []
  for key, group in itertools.groupby(tp.pairs, key=lambda p: (p.type1, p.type2)):
    group = list(group)
    g1 = np.asarray([p.geom1 for p in group])
    g2 = np.asarray([p.geom2 for p in group])
    prio1, prio2 = tp.geom_priority[g1], tp.geom_priority[g2]
    fn = _DISPATCH[key]
    if key == (_G.mjGEOM_PLANE, _G.mjGEOM_MESH):
      fn = functools.partial(fn, verts=_hull_verts(tp, g2, dtype, device))
    groups.append(
      SimpleNamespace(
        fn=fn, k=group[0].ncon, g1=index_tensor(g1, device),
        g2=index_tensor(g2, device),
        hi=index_tensor(np.where(prio1 >= prio2, g1, g2), device),
        differ=torch.as_tensor(prio1 != prio2, device=device)[:, None],
      )
    )
  return SimpleNamespace(groups=groups)


def _combine_params_vec(m: Model, g):
  """Vectorized mj_contactParam over a pair group (static priorities). A
  per-env `geom_friction` (B, ngeom, 3) gives a per-env friction (B, n, 5);
  every other result is shared by the batch."""
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
  return friction, solref, solimp, margin, torch.zeros_like(solref)


def collision(tp: Topology, m: Model, d: Data) -> Data:
  """One batched narrowphase call per type group, concatenated in slot order."""
  B = d.qpos.shape[0]
  if tp.ncon_max == 0:
    return d.replace(ncon_dropped=torch.zeros_like(d.ncon_dropped))
  parts: dict[str, list[torch.Tensor]] = {
    f: [] for f in ("dist", "pos", "frame", "friction", "solref", "solimp",
                    "includemargin", "solreffriction")
  }
  for g in tp.dev.coll.groups:
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
  contact = Contact(**{f: torch.cat(v, dim=1) for f, v in parts.items()})
  return d.replace(contact=contact, ncon_dropped=torch.zeros_like(d.ncon_dropped))
