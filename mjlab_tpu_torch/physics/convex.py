"""Convex hulls of collision meshes, built on the host (port of the host part
of mjlab_tpu/physics/convex.py: `Hull` and `build_hull`).

A mesh geom collides through the convex hull of its vertices, decimated to
at most MAX_HULL_VERTS so that every narrowphase has a fixed shape. The
hull is built once, at put_model, with numpy and scipy; the step sees only
the padded vertex arrays. The port's only hull pair is plane–mesh
(collision._plane_convex), which reads the vertices; the faces and edge
directions are kept so that a Hull equals the JAX package's field by field.
The JAX file's `pad_hulls` and its device SAT/clipping narrowphase serve
only hull–hull pairs, which put_model refuses, so they are left out.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_HULL_VERTS = 32
MAX_FACE_VERTS = 8


@dataclasses.dataclass(frozen=True)
class Hull:
  """Convex hull in the geom frame (host numpy). Faces pad by repeating
  their last vertex."""

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

