"""Convex narrowphase (port of mjlab_tpu/physics/convex.py): hulls built on
the host, and the SAT over hull face and edge axes with incident-face
clipping on the device.

A mesh geom collides through the convex hull of its vertices, decimated to
at most MAX_HULL_VERTS so that every narrowphase has a fixed shape. The
hull is built once, at put_model, with numpy and scipy; the step sees only
padded arrays (`pad_hulls`). `convex_convex` serves every pair of convex
shapes: box–box, box–mesh, mesh–mesh, sphere–mesh and capsule–mesh (a
cylinder or an ellipsoid collides as a tessellated mesh hull), and the box
and mesh geoms against a box terrain pool. It is plain batched torch over
any leading batch shape, and mirrors the JAX function operation by
operation: the same axes, thresholds and fixed-size Sutherland–Hodgman
clipping, and the same ties (the lower index first among equal depths, as
jax.lax.top_k and jnp.argmin/argmax break them).

Approximations against exact collision (the JAX package's): the separation
is measured along the face normals, the edge-cross axes (skipped when
|E1|·|E2| exceeds EDGE_AXIS_BUDGET) and, for rounded shapes, the vertex
axes only, so some corner–corner distances are slightly underestimated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt

MAX_HULL_VERTS = 32
MAX_FACE_VERTS = 8
EDGE_AXIS_BUDGET = 600  # the most |E1|·|E2| with edge-cross axes


@dataclasses.dataclass(frozen=True)
class Hull:
  """Convex hull in the geom frame (host numpy). Faces pad by repeating
  their last vertex: pads are no-ops in the support reductions, and the
  clipper skips the degenerate edges they make."""

  verts: np.ndarray  # (V, 3)
  face_verts: np.ndarray  # (F, MAX_FACE_VERTS) vertex indices into verts
  face_normals: np.ndarray  # (F, 3) outward unit normals
  edge_dirs: np.ndarray  # (E, 3) unique edge directions (unit, sign-canonical)


def _fibonacci_directions(n: int) -> np.ndarray:
  i = np.arange(n, dtype=np.float64)
  phi = np.pi * (3.0 - np.sqrt(5.0))
  z = 1.0 - 2.0 * (i + 0.5) / n
  r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
  th = phi * i
  return np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1)


def build_hull(
  verts: np.ndarray,
  max_verts: int = MAX_HULL_VERTS,
  max_face_verts: int = MAX_FACE_VERTS,
) -> Hull:
  """Decimate, hull, merge coplanar faces, and collect unique edge
  directions."""
  from scipy.spatial import ConvexHull

  verts = np.asarray(verts, dtype=np.float64)
  if len(verts) > max_verts:
    # Keep the extreme vertex along each of a uniform set of directions:
    # this keeps the overall shape and the flat load-bearing soles.
    dirs = _fibonacci_directions(max_verts)
    verts = verts[np.unique(np.argmax(dirs @ verts.T, axis=1))]
  hull = ConvexHull(verts, qhull_options="QJ")  # joggle degenerate inputs
  vid = hull.vertices
  remap = -np.ones(len(verts), dtype=np.int64)
  remap[vid] = np.arange(len(vid))
  verts = verts[vid]
  tris = remap[hull.simplices]  # (T, 3)
  normals = hull.equations[:, :3]
  normals = normals / np.linalg.norm(normals, axis=-1, keepdims=True)

  # Merge coplanar triangles into polygon faces.
  groups: list[list[int]] = []
  gnorm: list[np.ndarray] = []
  for t in range(len(tris)):
    n = normals[t]
    for gi, g in enumerate(groups):
      if float(np.dot(gnorm[gi], n)) > 1.0 - 1e-6:
        g.append(t)
        break
    else:
      groups.append([t])
      gnorm.append(n)

  face_verts, face_normals = [], []
  for g, n in zip(groups, gnorm):
    vset = np.unique(tris[g].reshape(-1))
    pts = verts[vset]
    c = pts.mean(axis=0)
    # Order counter-clockwise around the outward normal.
    t1 = pts[0] - c
    t1 = t1 / max(np.linalg.norm(t1), 1e-12)
    t2 = np.cross(n, t1)
    ang = np.arctan2((pts - c) @ t2, (pts - c) @ t1)
    ring = vset[np.argsort(ang)]
    if len(ring) > max_face_verts:
      # Subsample evenly around the ring (stays convex, slightly inset).
      keep = np.round(np.linspace(0, len(ring), max_face_verts, endpoint=False))
      ring = ring[np.unique(keep.astype(int))]
    pad = np.full(max_face_verts, ring[-1], dtype=np.int64)
    pad[: len(ring)] = ring
    face_verts.append(pad)
    face_normals.append(n)

  # Unique edge directions (sign-canonical) from the face rings.
  dirs: list[np.ndarray] = []
  for fv in face_verts:
    ring = list(dict.fromkeys(fv.tolist()))
    for a, b in zip(ring, ring[1:] + ring[:1]):
      e = verts[b] - verts[a]
      ln = np.linalg.norm(e)
      if ln < 1e-12:
        continue
      e = e / ln
      if e[2] < 0 or (e[2] == 0 and (e[1] < 0 or (e[1] == 0 and e[0] < 0))):
        e = -e
      if not any(float(np.dot(e, d)) > 1.0 - 1e-6 for d in dirs):
        dirs.append(e)
  return Hull(
    verts=np.asarray(verts),
    face_verts=np.asarray(face_verts, dtype=np.int64),
    face_normals=np.asarray(face_normals),
    edge_dirs=np.asarray(dirs) if dirs else np.zeros((1, 3)),
  )



# The unit box's hull as the JAX package's build_hull makes it from the 8
# corners (x slowest, z fastest): qhull's joggle ("QJ") leaves its face
# normals ~1e-11 off the axes, which the SAT's depths inherit, so the
# values are copied here exactly (tests/test_torch_convex.py holds them
# equal to the JAX package's BOX_HULL).
BOX_HULL = Hull(
  verts=np.asarray(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
  ),
  face_verts=np.asarray(
    [[2, 0, 1, 3, 3, 3, 3, 3], [3, 1, 5, 7, 7, 7, 7, 7], [5, 4, 6, 7, 7, 7, 7, 7],
     [4, 0, 2, 6, 6, 6, 6, 6], [1, 0, 4, 5, 5, 5, 5, 5], [6, 2, 3, 7, 7, 7, 7, 7]],
    dtype=np.int64,
  ),
  face_normals=np.asarray([
    [-1.0, -6.212586001664623e-12, 1.669953064734908e-11],
    [-6.32605079096523e-13, -1.9260038008157234e-11, 1.0],
    [1.0, 3.420153049947456e-12, -2.173161650624413e-11],
    [2.9571900485945518e-12, 6.537492769250982e-12, -1.0],
    [-2.922373454344511e-11, -1.0, -2.2335688853908443e-11],
    [-1.7106982497097096e-11, 1.0, 6.654343742514228e-12],
  ]),
  edge_dirs=np.asarray([[-0.0, 1.0, -0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]),
)

# Degenerate "hulls" of the rounded shapes (a sphere is a point, a capsule
# its z segment, each inflated by its radius). Their zero face normals and
# edge directions drop out of the axis set at run time.
SPHERE_HULL = Hull(
  verts=np.zeros((1, 3)),
  face_verts=np.zeros((1, MAX_FACE_VERTS), dtype=np.int64),
  face_normals=np.zeros((1, 3)),
  edge_dirs=np.zeros((1, 3)),
)
CAPSULE_HULL = Hull(
  verts=np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]]),
  face_verts=np.asarray([[0, 1] + [1] * (MAX_FACE_VERTS - 2)], dtype=np.int64),
  face_normals=np.zeros((1, 3)),
  edge_dirs=np.asarray([[0.0, 0.0, 1.0]]),
)


def pad_hulls(hulls: list[Hull]) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
  """Stack a group of hulls padded to a common (V, F, E) by repeating each
  one's last rows (repeats are no-ops in the support reductions)."""
  Vm = max(h.verts.shape[0] for h in hulls)
  Fm = max(h.face_verts.shape[0] for h in hulls)
  Em = max(h.edge_dirs.shape[0] for h in hulls)

  def padrows(a, n):
    reps = np.broadcast_to(a[-1:], (n - a.shape[0],) + a.shape[1:])
    return np.concatenate([a, reps])

  verts = np.stack([padrows(h.verts, Vm) for h in hulls])
  fv = np.stack([padrows(h.face_verts, Fm) for h in hulls])
  fn = np.stack([padrows(h.face_normals, Fm) for h in hulls])
  ed = np.stack([padrows(h.edge_dirs, Em) for h in hulls])
  return verts, fv, fn, ed


# ---------------------------------------------------------------------------
# The batched narrowphase. Every tensor carries the pairs' batch shape in
# front (any shape that broadcasts); indices break ties as JAX does.
# ---------------------------------------------------------------------------


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """a (..., n, 3) @ v (..., 3) → (..., n)."""
  return (a @ v[..., None])[..., 0]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """x (..., N, C) at indices idx (..., M) → (..., M, C); both carry the
  same batch shape."""
  return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
  """Index of the least value along the last axis, the lowest index among
  equals (as jnp.argmin); a row without a least value (NaN) gives the last
  index."""
  n = x.shape[-1]
  idx = torch.arange(n, device=x.device)
  least = torch.amin(x, dim=-1, keepdim=True)
  return torch.amin(torch.where(x == least, idx, n), dim=-1).clamp_max(n - 1)


def _prefix_valid(ring: torch.Tensor) -> torch.Tensor:
  """Valid mask (..., R) of a ring (..., R, 3) padded by repetition: a
  vertex equal to the one before it is a pad (the first never is)."""
  n = ring.shape[-2]
  same = torch.all(torch.abs(ring - torch.roll(ring, 1, dims=-2)) < 1e-12, dim=-1)
  return ~same | (torch.arange(n, device=ring.device) == 0)


def _clip_polygon(poly, valid, ref_ring, ref_n):
  """Clip the polygons `poly` (..., P, 3) (points where `valid`) against
  the side planes of the convex rings `ref_ring` (..., R, 3), counter-
  clockwise about their outward normals `ref_n` (..., 3). Branchless fixed-
  size Sutherland–Hodgman: each of the R steps emits [keep_i, inter_i] per
  point and compacts by a cumulative-sum scatter; a degenerate (pad) edge
  leaves the polygon as it was. Returns points (..., P + R, 3) and their
  mask."""
  batch = poly.shape[:-2]
  P0, R = poly.shape[-2], ref_ring.shape[-2]
  B = P0 + R
  P = torch.cat([poly, poly.new_zeros(batch + (R, 3))], dim=-2)
  m = torch.cat([valid, valid.new_zeros(batch + (R,))], dim=-1)
  count = m.sum(-1)
  idx = torch.arange(B, device=poly.device)
  for k in range(R):
    a = ref_ring[..., k, :]
    edge = ref_ring[..., (k + 1) % R, :] - a
    n_side = mt.cross(ref_n, edge)  # inward for a counter-clockwise ring
    nn = torch.linalg.vector_norm(n_side, dim=-1)
    degenerate = nn < 1e-10
    n_side = n_side / torch.clamp_min(nn, 1e-12)[..., None]
    s = _mv(P - a[..., None, :], n_side)  # >= 0: inside
    # JAX clamps an out-of-range gather index; the buffer never overflows
    # for a convex input, but the clamp keeps the two equal where it would.
    nxt_i = ((idx + 1) % torch.clamp_min(count, 1)[..., None]).clamp_max(B - 1)
    nxt = _take(P, nxt_i)
    s_nxt = _mv(nxt - a[..., None, :], n_side)
    active = m & (idx < count[..., None])
    inside, inside_nxt = s >= 0, s_nxt >= 0
    keep = active & inside
    crossing = active & (inside != inside_nxt)
    diff = s - s_nxt
    denom = torch.where(torch.abs(diff) < 1e-12, torch.ones_like(diff), diff)
    inter = P + (s / denom)[..., None] * (nxt - P)
    emit = torch.stack([keep, crossing], dim=-1).flatten(-2)  # (..., 2B)
    pts = torch.stack([P, inter], dim=-2).flatten(-3, -2)  # (..., 2B, 3)
    pos = torch.cumsum(emit, dim=-1) - 1
    # Scatter into B + 1 rows: non-emitted points (and any past the
    # buffer, JAX's mode="drop") land in the last row, which is cut off.
    dest = torch.where(emit & (pos < B), pos, B)
    newP = P.new_zeros(batch + (B + 1, 3)).scatter(
      -2, dest[..., None].expand(*dest.shape, 3), pts
    )[..., :B, :]
    newcount = emit.sum(-1)
    P = torch.where(degenerate[..., None, None], P, newP)
    m = torch.where(degenerate[..., None], m, idx < newcount[..., None])
    count = torch.where(degenerate, count, newcount)
  return P, m


def _normal_frame_rows(n: torch.Tensor) -> torch.Tensor:
  """Right-handed frames (..., 3, 3) with rows [n, t1, t2] from unit normals."""
  # torch.eye fills on the device; a torch.tensor literal would be a
  # host-to-device copy, and a stream sync, on every step.
  eye = torch.eye(3, dtype=n.dtype, device=n.device)
  ref = torch.where((torch.abs(n[..., 0]) < 0.5)[..., None], eye[0], eye[1])
  t1 = mt.cross(n, ref)
  t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1), 1e-12)[..., None]
  t2 = mt.cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def convex_convex(
  pos1, mat1, verts1, face_verts1, face_normals1, edge_dirs1,
  pos2, mat2, verts2, face_verts2, face_normals2, edge_dirs2,
  r1=0.0, r2=0.0, ncon: int = 4,
  use_edge_axes: bool = True,
  vertex_axes: bool = False,
  clip_mode: str = "both",
):
  """Convex pair narrowphase over a batch of pairs.

  Hull data is in each geom's frame: verts (..., V, 3), face_verts (..., F,
  MAX_FACE_VERTS) integer, face_normals (..., F, 3), edge_dirs (..., E,
  3); r1 and r2 inflate the hulls by a radius (a float or (...)). Poses
  are pos (..., 3) and mat (..., 3, 3). clip_mode "both" clips each hull's
  incident face against the other's reference face and merges the
  candidates (hull–hull); "1on2" clips only hull 1's supporting ring
  against hull 2's face (a capsule, whose ring is its segment); "none"
  keeps only the deepest-support point (a sphere). vertex_axes adds axes
  from hull 2's vertices toward hull 1's point or segment.

  Returns dist (..., ncon), pos (..., ncon, 3) and frame (..., ncon, 3,
  3), the normal pointing geom1 → geom2; an empty slot has dist 1e10."""
  dtype, device = pos1.dtype, pos1.device

  def bshape(x, k):
    return x.shape[:-k] if torch.is_tensor(x) else ()

  batch = torch.broadcast_shapes(
    bshape(pos1, 1), bshape(mat1, 2), bshape(verts1, 2), bshape(face_verts1, 2),
    bshape(face_normals1, 2), bshape(edge_dirs1, 2), bshape(pos2, 1), bshape(mat2, 2),
    bshape(verts2, 2), bshape(face_verts2, 2), bshape(face_normals2, 2),
    bshape(edge_dirs2, 2), bshape(r1, 0), bshape(r2, 0),
  )

  def full(x, k):  # x with the whole batch shape in front (a view)
    return x.expand(batch + x.shape[x.dim() - k:])

  pos1, mat1, pos2, mat2 = full(pos1, 1), full(mat1, 2), full(pos2, 1), full(mat2, 2)
  # Work in hull 1's frame.
  mt1 = mat1.transpose(-1, -2)
  R = mt1 @ mat2
  t = _mv(mt1, pos2 - pos1)
  v1 = full(verts1, 2)
  v2 = verts2 @ R.transpose(-1, -2) + t[..., None, :]
  n1 = full(face_normals1, 2)
  n2 = face_normals2 @ R.transpose(-1, -2)
  c1 = torch.mean(v1, dim=-2)
  c2 = torch.mean(v2, dim=-2)

  axes = [n1, -n2]
  if use_edge_axes:
    e1 = edge_dirs1
    e2 = edge_dirs2 @ R.transpose(-1, -2)
    cx = mt.cross(e1[..., :, None, :], e2[..., None, :, :]).flatten(-3, -2)
    cn = torch.linalg.vector_norm(cx, dim=-1, keepdim=True)
    cx = torch.where(cn > 1e-6, cx / torch.clamp_min(cn, 1e-12), torch.zeros_like(cx))
    sgn = torch.where(_mv(cx, c2 - c1) < 0, -1.0, 1.0).to(dtype)
    axes.append(cx * sgn[..., None])
  if vertex_axes:
    # From each hull-2 vertex toward the nearest point of hull 1's point or
    # segment: exact corner and edge normals for the rounded shapes.
    if v1.shape[-2] == 1:
      w = v1[..., :1, :]
    else:
      a_, b_ = v1[..., 0, :], v1[..., -1, :]
      ab = b_ - a_
      tt = torch.clamp(
        _mv(v2 - a_[..., None, :], ab)
        / torch.clamp_min(torch.sum(ab * ab, dim=-1), 1e-12)[..., None], 0.0, 1.0,
      )
      w = a_[..., None, :] + tt[..., None] * ab[..., None, :]
    va = v2 - w
    vn = torch.linalg.vector_norm(va, dim=-1, keepdim=True)
    axes.append(torch.where(vn > 1e-9, va / torch.clamp_min(vn, 1e-12), torch.zeros_like(va)))
  A = torch.cat([full(x, 2) for x in axes], dim=-2)
  ok = torch.linalg.vector_norm(A, dim=-1) > 0.5
  s1 = A @ v1.transpose(-1, -2)  # (..., axes, V1)
  s2 = A @ v2.transpose(-1, -2)
  gaps = torch.where(ok, torch.amin(s2, dim=-1) - torch.amax(s1, dim=-1), -torch.inf)
  best = _first_argmin(-gaps)
  a = _take(A, best[..., None])[..., 0, :]  # separating axis, hull 1's frame, 1 → 2
  sep = torch.gather(gaps, -1, best[..., None])[..., 0]
  d1, d2 = _mv(v1, a), _mv(v2, a)
  h1 = torch.amax(d1, dim=-1)  # hull 1's support plane height along a
  h2 = torch.amin(d2, dim=-1)

  # Candidate points, each with its own distance along the axis to the
  # opposing face plane (a global face gap would give every manifold corner
  # the deepest penetration when the faces tilt, and sustain rocking).
  cands = []
  if clip_mode in ("both", "1on2"):
    f1 = _first_argmin(-_mv(n1, a))
    f2 = _first_argmin(_mv(n2, a))
    n1f = _take(n1, f1[..., None])[..., 0, :]
    n2f = _take(n2, f2[..., None])[..., 0, :]
    fv1 = _take(full(face_verts1, 2), f1[..., None])[..., 0, :]  # (..., MAX_FACE_VERTS)
    fv2 = _take(full(face_verts2, 2), f2[..., None])[..., 0, :]
    q1 = _take(v1, fv1[..., :1])[..., 0, :]
    q2 = _take(v2, fv2[..., :1])[..., 0, :]
    ring1, ring2 = _take(v1, fv1), _take(v2, fv2)

    def plane_gap(pts, nf, q0, fallback):
      # The signed gap along ±a from each point to the plane (nf, q0),
      # positive when separated; the face-height gap where the plane is
      # nearly parallel to the axis.
      denom = torch.sum(nf * a, dim=-1)
      flat = (torch.abs(denom) < 1e-6)[..., None]
      safe = torch.where(flat[..., 0], torch.ones_like(denom), denom)
      tq = (torch.sum(nf * q0, dim=-1)[..., None] - _mv(pts, nf)) / safe[..., None]
      return torch.where(flat, fallback, tq)

    if clip_mode == "both":
      pts_a, m_a = _clip_polygon(ring2, _prefix_valid(ring2), ring1, n1f)
      # Points on hull 2's incident face; the gap to hull 1's reference
      # plane (negated: positive above it; the fallback pre-negated).
      cands.append((pts_a, m_a, -plane_gap(pts_a, n1f, q1, h1[..., None] - _mv(pts_a, a))))
    pts_b, m_b = _clip_polygon(ring1, _prefix_valid(ring1), ring2, n2f)
    cands.append((pts_b, m_b, plane_gap(pts_b, n2f, q2, h2[..., None] - _mv(pts_b, a))))
  # The deepest-support midpoint, only where clipping gave no point (its
  # distance is `sep`, the deepest by construction: always competing, it
  # would take a slot from a true support corner). A point hull (a sphere)
  # contacts at its centre's lateral position.
  if v1.shape[-2] == 1:
    mid = v1[..., 0, :]
  else:
    mid = 0.5 * (_take(v1, _first_argmin(-d1)[..., None])[..., 0, :]
                 + _take(v2, _first_argmin(d2)[..., None])[..., 0, :])
  if cands:
    have_clip = torch.zeros(batch, dtype=torch.bool, device=device)
    for _, cm, _ in cands:
      have_clip = have_clip | torch.any(cm, dim=-1)
    mid_mask = ~have_clip
  else:
    mid_mask = torch.ones(batch, dtype=torch.bool, device=device)
  cands.append((mid[..., None, :], mid_mask[..., None], sep[..., None]))

  pts = torch.cat([c[0] for c in cands], dim=-2)
  mask = torch.cat([c[1] for c in cands], dim=-1)
  rr = r1 + r2
  dist_all = torch.cat([c[2] for c in cands], dim=-1) - (rr[..., None] if torch.is_tensor(rr) else rr)
  dist_all = torch.where(mask, dist_all, torch.inf)

  # The deepest candidates with a greedy lateral dedupe: the two clip
  # directions give coincident manifold corners; anything within 2 mm
  # laterally merges, so that the ncon points span distinct corners.
  k = min(2 * ncon + 1, pts.shape[-2])
  order = torch.sort(dist_all, dim=-1, stable=True).indices[..., :k]  # top_k of -dist
  cand = _take(pts, order)
  cdist = torch.gather(dist_all, -1, order)
  lateral = cand - _mv(cand, a)[..., None] * a[..., None, :]
  taken = torch.zeros(batch + (k,), dtype=torch.bool, device=device)
  arange = torch.arange(k, device=device)
  sel_pts, sel_dist = [], []
  for _ in range(ncon):
    score = torch.where(taken, torch.inf, cdist)
    j = _first_argmin(score)[..., None]
    sel_pts.append(_take(cand, j)[..., 0, :])
    score_j = torch.gather(score, -1, j)[..., 0]
    sel_dist.append(torch.where(torch.isinf(score_j), torch.inf,
                                torch.gather(cdist, -1, j)[..., 0]))
    close = torch.sum((lateral - _take(lateral, j)) ** 2, dim=-1) < (2e-3) ** 2
    taken = taken | close | (arange == j)
  sel = torch.stack(sel_pts, dim=-2)  # (..., ncon, 3)
  dist = torch.stack(sel_dist, dim=-1)

  # Each point projected onto the midplane between the two (inflated)
  # support surfaces, keeping its lateral position.
  midplane = 0.5 * (h1 + r1 + h2 - r2)
  pos_local = sel - (_mv(sel, a) - midplane[..., None])[..., None] * a[..., None, :]
  bad = ~torch.isfinite(dist)
  dist = torch.where(bad, 1e10, dist)
  pos_local = torch.where(bad[..., None], 0.0, pos_local)
  pos_w = pos1[..., None, :] + pos_local @ mat1.transpose(-1, -2)
  frame = _normal_frame_rows(_mv(mat1, a))
  return dist, pos_w, frame[..., None, :, :].expand(batch + (ncon, 3, 3))
