"""The box-terrain collision of the PyTorch port against the JAX package
(float64, CPU): the box primitives (`_sphere_box_impl`, `_plane_box`,
`_sphere_box`, `_capsule_box`) on seeded random poses with centred points
and level boxes, to 1e-12; and on a toy scene of 80 stair boxes (over
TERRAIN_POOL_MIN, so they form a terrain pool) with a free sphere and a
free capsule, the terrain groups, `_terrain_group_contacts` (also at fewer
slots, so that contacts are dropped) and the whole `collision` from the
JAX package's geom poses, to 1e-9 with the dropped counts exact. A
height field still raises, naming the feature; box and mesh geoms against
a pool form their groups (the hull SAT, tests/test_torch_convex.py)."""

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
from mjlab_tpu.physics.kinematics import kinematics as jkinematics
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import io as tio

N = 256  # random pairs per primitive
PRIM_TOL = 1e-12
CONTACT_TOL = 1e-9

# 10 x 8 tiles of 0.5 m; the tread rises 0.08 m every second tile along x,
# so that pairs of tiles are coplanar (seams) and the rest are steps.
NX, NY, TILE, RISE = 10, 8, 0.5, 0.08


def _top(ix: int) -> float:
  return RISE * (ix // 2)


def _terrain_xml(robot: str) -> str:
  boxes = "\n".join(
    f'<geom type="box" size="{TILE / 2} {TILE / 2} 0.5" '
    f'pos="{(ix - NX / 2 + 0.5) * TILE} {(iy - NY / 2 + 0.5) * TILE} {_top(ix) - 0.5}"/>'
    for ix in range(NX) for iy in range(NY)
  )
  return f"""
<mujoco>
  <option timestep="0.005" integrator="implicitfast"/>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/>
    <hfield name="hf" nrow="3" ncol="3" size="1 1 0.1 0.1"/>
  </asset>
  <default>
    <geom friction="0.8 0.01 0.001" solref="0.01 1" solimp="0.9 0.95 0.002 0.5 2"/>
  </default>
  <worldbody>
    <body name="terrain">
{boxes}
    </body>
{robot}
  </worldbody>
</mujoco>"""


ROBOT_XML = """
    <body name="ball" pos="0 0 1"><freejoint/>
      <geom type="sphere" size="0.1" condim="3" solmix="2" friction="1.1 0.02 0.002"/>
    </body>
    <body name="rod" pos="1 0 1"><freejoint/>
      <geom type="capsule" size="0.05 0.3" condim="1" priority="1"
            solref="0.02 1.2" friction="0.6 0.005 0.0001"/>
    </body>"""


@functools.lru_cache(maxsize=None)
def _toy():
  mj = mujoco.MjModel.from_xml_string(_terrain_xml(ROBOT_XML))
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  return mj, jtp, jm, ttp, tm


def _rot(rng, n):
  return Rotation.random(n, random_state=rng).as_matrix()


def _tie_cases(p1, m1, p2, m2, s2):
  """Put the first quarter of the pairs' point on its box's centre (every
  face ties for a cube) and level the second quarter's boxes."""
  q = len(p1) // 4
  s2[:q] = s2[:q, :1]  # cubes
  p1[:q] = p2[:q]
  m2[q : 2 * q] = np.eye(3)
  m1[q : 2 * q] = np.eye(3)


def _inputs(seed: int):
  rng = np.random.default_rng(seed)
  p1, p2 = rng.normal(0.0, 0.3, (N, 3)), rng.normal(0.0, 0.3, (N, 3))
  m1, m2 = _rot(rng, N), _rot(rng, N)
  s1 = np.stack([rng.uniform(0.02, 0.2, N), rng.uniform(0.05, 0.4, N), np.zeros(N)], -1)
  s2 = rng.uniform(0.05, 0.4, (N, 3))
  _tie_cases(p1, m1, p2, m2, s2)
  return p1, m1, s1, p2, m2, s2


def _close(got, want, what):
  for g, w, part in zip(got, want, ("dist", "pos", "frame/normal")):
    tp.assert_close(np.asarray(g), np.asarray(w), PRIM_TOL, f"{what} {part}")


@pytest.mark.parametrize("name", ["_plane_box", "_sphere_box", "_capsule_box"])
def test_box_pair_primitives_match_jax(name):
  p1, m1, s1, p2, m2, s2 = _inputs(1)
  want = jax.vmap(getattr(jcoll, name))(*map(jnp.asarray, (p1, m1, s1, p2, m2, s2)))
  t = [torch.as_tensor(x) for x in (p1, m1, s1, p2, m2, s2)]
  got = getattr(tcoll, name)(t[0][None], t[1][None], t[2], t[3][None], t[4][None], t[5])
  _close([g[0] for g in got], want, name)


def test_plane_box_keeps_the_lower_corners_of_a_level_box():
  """A level box puts 4 corners at one depth: both keep corners 0, 2, 4, 6
  (x slowest, z fastest), the lower index first."""
  _, _, _, p2, _, s2 = _inputs(2)
  eye = np.broadcast_to(np.eye(3), (N, 3, 3))
  want = jax.vmap(jcoll._plane_box)(*map(jnp.asarray, (np.zeros((N, 3)), eye, s2, p2, eye, s2)))
  t = [torch.as_tensor(np.ascontiguousarray(x)) for x in (np.zeros((N, 3)), eye, s2, p2, eye, s2)]
  got = tcoll._plane_box(t[0][None], t[1][None], t[2], t[3][None], t[4][None], t[5])
  _close([g[0] for g in got], want, "level _plane_box")
  corners = tcoll._box_corners(torch.as_tensor(s2))
  np.testing.assert_array_equal(got[1][0].numpy() + 0.5 * got[0][0, ..., None].numpy() * [0, 0, 1],
                                (torch.as_tensor(p2)[:, None] + corners[:, [0, 2, 4, 6]]).numpy())


def test_sphere_box_impl_matches_jax():
  p1, _, s1, p2, m2, s2 = _inputs(3)
  want = jax.vmap(jcoll._sphere_box_impl)(*map(jnp.asarray, (p1, s1[:, 0], p2, m2, s2)))
  got = tcoll._sphere_box_impl(*(torch.as_tensor(x) for x in (p1, s1[:, 0], p2, m2, s2)))
  _close(got, want, "_sphere_box_impl")
  # The centred points leave through face 0 (x), with a zero normal: the
  # JAX package's sign(0).
  q = N // 4
  assert np.all(np.asarray(want[2])[:q] == 0.0)


def _states(mj, n: int, seed: int) -> np.ndarray:
  """Seeded qpos: the sphere and the capsule over the stairs just touching
  or sinking into the treads, many on tile seams and in step corners, the
  capsule level, tilted or upright."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  for body, (adr, r) in {"ball": (0, 0.1), "rod": (7, 0.05)}.items():
    ix = rng.integers(1, NX - 1, n)
    x = (ix - NX / 2) * TILE + rng.choice([0.0, 0.02, TILE / 2], n)  # seams, corners
    y = (rng.integers(1, NY - 1, n) - NY / 2) * TILE + rng.choice([0.0, 0.1, 0.25], n)
    top = np.maximum(RISE * (ix // 2), RISE * ((ix - 1) // 2))
    z = top + r - rng.uniform(-0.01, 0.03, n)
    qpos[:, adr : adr + 3] = np.stack([x, y, z], -1)
    if body == "rod":
      yaw = rng.uniform(-np.pi, np.pi, n)
      # The capsule's axis is its local z: level, tilted or upright.
      tilt = np.pi / 2 + np.where(np.arange(n) % 2 == 0, 0.0, rng.uniform(-0.4, 0.4, n))
      tilt[::5] = 0.0
      quat = Rotation.from_euler("zy", np.stack([yaw, tilt], -1)).as_quat()  # x, y, z, w
      qpos[:, adr + 3 : adr + 7] = quat[:, [3, 0, 1, 2]]
  return qpos


@functools.lru_cache(maxsize=None)
def _posed(n: int = 24, seed: int = 5):
  """The JAX package's Data after kinematics for the seeded states, and
  the same as the port's Data."""
  mj, jtp, jm, ttp, tm = _toy()
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(_states(mj, n, seed)))
  d = jax.jit(jax.vmap(lambda d: jkinematics(jtp, jm, d)))(d)
  return d, tp.to_torch(tp.jax_data_arrays(d))


def test_terrain_groups_equal():
  _, jtp, _, ttp, _ = _toy()
  assert [g.robot_type for g in ttp.terrain_groups] == [mujoco.mjtGeom.mjGEOM_SPHERE,
                                                       mujoco.mjtGeom.mjGEOM_CAPSULE]
  for got, want in zip(ttp.terrain_groups, jtp.terrain_groups, strict=True):
    for f in dataclasses.fields(want):
      x, y = getattr(got, f.name), getattr(want, f.name)
      if isinstance(y, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name
      else:
        assert x == y, f.name
  assert (ttp.ncon_max, ttp.nefc) == (jtp.ncon_max, jtp.nefc)
  assert len(ttp.pairs) == len(jtp.pairs) == 1  # sphere–capsule only: boxes are pooled


@pytest.mark.parametrize("slots", [6, 2])
def test_terrain_group_contacts_match_jax(slots):
  """Each group's slots and dropped count, at the group's 6 slots and at 2,
  where the deepest-first selection drops active contacts."""
  _, jtp, jm, ttp, tm = _toy()
  jd, td = _posed()
  dropped = 0
  for jtg in jtp.terrain_groups:
    jtg = dataclasses.replace(jtg, slots=slots)
    want = jax.jit(jax.vmap(lambda d: jcoll._terrain_group_contacts(jtp, jm, d, jtg)))(jd)
    tabs = tcoll._terrain_tables(ttp, jtg, torch.float64, "cpu")
    got = tcoll._terrain_group_contacts(tm, td, tabs)
    names = ("dist", "pos", "frame", "friction", "solref", "solimp", "includemargin")
    for g, w, name in zip(got[:-1], want[:-1], names):
      tp.assert_close(g.numpy(), np.asarray(w), CONTACT_TOL, f"{jtg.robot_type}:{name}")
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    assert got[-1].dtype == torch.int32
    dropped += int(got[-1].sum())
    assert (np.asarray(want[0]) < np.asarray(want[6])).any()  # active contacts
  assert (dropped > 0) == (slots == 2)


def test_collision_matches_jax():
  _, jtp, jm, ttp, tm = _toy()
  jd, td = _posed()
  want = jax.jit(jax.vmap(lambda d: jcoll.collision(jtp, jm, d)))(jd)
  got = tcoll.collision(ttp, tm, td)
  for f in dataclasses.fields(got.contact):
    tp.assert_close(getattr(got.contact, f.name).numpy(),
                    np.asarray(getattr(want.contact, f.name)), CONTACT_TOL, f.name)
  np.testing.assert_array_equal(got.ncon_dropped.numpy(), np.asarray(want.ncon_dropped))
  active = (got.contact.dist < got.contact.includemargin).sum(dim=1)
  assert (active > 0).sum() >= len(active) // 2, active


@pytest.mark.parametrize("robot,name", [
  ('<body pos="0 0 1"><freejoint/><geom type="box" size="0.1 0.1 0.1"/></body>', "geom type 6"),
  ('<body pos="0 0 1"><freejoint/><geom type="mesh" mesh="tet"/></body>', "geom type 7"),
  ('<geom type="hfield" hfield="hf" pos="9 9 0"/>'
   '<body pos="9 9 1"><freejoint/><geom type="sphere" size="0.1"/></body>', r"geom types \(1, 2\)"),
])
def test_box_mesh_and_hfield_against_the_pool_raise(robot, name):
  """A height field still raises, naming its pair; a box or a mesh geom
  against the pool now forms a terrain group of its type (the hull SAT;
  its parity: tests/test_torch_convex.py), as in the JAX package."""
  mj = mujoco.MjModel.from_xml_string(_terrain_xml(robot))
  if "hfield" in robot:
    with pytest.raises(NotImplementedError, match=name):
      tio.put_model(mj, dtype=torch.float64, device="cpu")
    return
  ttp, _ = tio.put_model(mj, dtype=torch.float64, device="cpu")
  jtp, _ = jphysics.put_model(mj, dtype=jnp.float64)
  geom_type = int(name.split()[-1])
  assert [g.robot_type for g in ttp.terrain_groups] == [
    g.robot_type for g in jtp.terrain_groups] == [geom_type]
  assert (ttp.ncon_max, ttp.nefc) == (jtp.ncon_max, jtp.nefc)
