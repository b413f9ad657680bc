"""The rough scenes of Go1, Asimov and Asimov-Toe (Mjlab-Velocity-Rough-
Unitree-Go1, -Asimov, -Asimov-Toe) in the PyTorch port against the JAX
package (float64, CPU): the port's put_model on each committed npz against
the JAX package's on a fresh compile — the terrain groups array for array,
the pairs, the slot tables, the contact slots and Newton rows (180 / 732,
12 / 60, 120 / 494) and the hulls; the six committed rough and play npz
files' freshness, with the Asimov feet's hull vertices kept; and
`collision` on each whole scene from the JAX package's geom poses, with
the feet and the trunk on seams, stairs and step edges (the positions of
inactive slots excepted, tests/torch_parity.py `check_terrain_slots`),
the dropped counts exact and non-zero."""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import chip_smoke
import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import collision as jcoll
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics.kinematics import kinematics as jkinematics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics import kinematics as tk
from mjlab_tpu_torch.physics.types import ConeType

NAMES = ("go1", "asimov", "asimov_toe")
# (contact slots, Newton rows, nv, terrain groups (robot geom type, geoms))
SIZES = {
  "go1": (180, 732, 18, [(2, 5), (3, 24), (6, 1)]),
  "asimov": (12, 60, 18, [(7, 2)]),
  "asimov_toe": (120, 494, 20, [(3, 20)]),
}


@functools.lru_cache(maxsize=None)
def _models(name: str):
  mj, origins = tp.rough_scene(name)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(assets.load_model_npz(tp.rough_npz(name)), dtype=torch.float64,
                          device="cpu")
  return mj, origins, jtp, jm, ttp, tm


@pytest.mark.parametrize("name", NAMES)
def test_topology_equals_jax(name):
  *_, jtp, _, ttp, _ = _models(name)
  slots, rows, nv, groups = SIZES[name]
  assert (ttp.ncon_max, ttp.nefc, ttp.nv) == (jtp.ncon_max, jtp.nefc, jtp.nv) == (slots, rows, nv)
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [
    dataclasses.astuple(p) for p in jtp.pairs] == []
  assert [(g.robot_type, len(g.robot_geoms)) for g in ttp.terrain_groups] == groups
  for got, want in zip(ttp.terrain_groups, jtp.terrain_groups, strict=True):
    for f in dataclasses.fields(want):
      x, y = getattr(got, f.name), getattr(want, f.name)
      if isinstance(y, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name
      else:
        assert x == y, f.name
  assert sorted(ttp.geom_hulls) == sorted(jtp.geom_hulls)
  for g, h in jtp.geom_hulls.items():
    for f in dataclasses.fields(h):
      assert np.array_equal(getattr(ttp.geom_hulls[g], f.name), getattr(h, f.name)), (g, f)
  if name == "asimov":  # the hulls chip_smoke.py's phase 13 rebuilds on the card's host
    assert chip_smoke.hull_digest(ttp) == chip_smoke.ASIMOV_HULL_DIGEST
  got, want = tcon.slot_tables(ttp, ConeType.PYRAMIDAL), jcon.slot_tables(jtp, ConeType.PYRAMIDAL)
  for f in dataclasses.fields(want):
    np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                  np.asarray(getattr(want, f.name)), err_msg=f.name)


@pytest.mark.parametrize("play", [False, True], ids=["rough", "play"])
@pytest.mark.parametrize("name", NAMES)
def test_npz_is_fresh(name, play, tmp_path):
  """The committed npz equals save_model_npz of a fresh compile with its
  tile origins (the play scene: the JAX package's play overrides, 3 x 3
  tiles without the curriculum). The Asimov scenes keep the feet's hull
  vertices: their feet collide with the terrain pool only (no pair).

  Regenerate all six with:
  PYTHONPATH=.:tests JAX_PLATFORMS=cpu python -c "import torch_parity as tp; [tp.save_rough_npz(n, p) for n in ('go1', 'asimov', 'asimov_toe') for p in (False, True)]"
  """
  path = tp.rough_npz(name, play)
  mj, origins = tp.rough_scene(name, play)
  fresh = tmp_path / "fresh.npz"
  assets.save_model_npz(mj, fresh, terrain_origins=origins)
  with np.load(fresh) as a, np.load(path) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
  ns = assets.load_model_npz(path)
  assert ns.terrain_origins.shape == ((3, 3, 3) if play else (10, 20, 3))
  np.testing.assert_array_equal(ns.terrain_origins, origins)
  assert path.stat().st_size < 300_000
  groups = tio.put_model(ns, dtype=torch.float64, device="cpu")[0].terrain_groups
  feet = [g for tg in groups if tg.robot_type == 7 for g in tg.robot_geoms.tolist()]
  assert len(feet) == (2 if name == "asimov" else 0)
  assert np.nonzero(ns.geom_hull_vertnum)[0].tolist() == feet
  assert all(tio._hull_vertices(ns, g).shape == tio._hull_vertices(mj, g).shape for g in feet)


def _terrain_height(mj, xy: np.ndarray) -> np.ndarray:
  """The highest top of the terrain boxes under each point (n, 2)."""
  pool = [g for g in range(mj.ngeom)
          if mj.body_weldid[mj.geom_bodyid[g]] == 0 and mj.geom_type[g] == 6]
  lo, hi = np.stack([np.concatenate(tio._geom_world_aabb(mj, g)) for g in pool]).reshape(
    -1, 2, 3).transpose(1, 0, 2)
  under = ((xy[:, None] >= lo[None, :, :2]) & (xy[:, None] <= hi[None, :, :2])).all(-1)
  return np.where(under, hi[None, :, 2], -np.inf).max(axis=1)


def _four_box_corners(mj) -> np.ndarray:
  """The points (m, 3) where 4 terrain boxes' top faces meet at one height."""
  pool = [g for g in range(mj.ngeom)
          if mj.body_weldid[mj.geom_bodyid[g]] == 0 and mj.geom_type[g] == 6]
  corners = collections.Counter()
  for g in pool:
    lo, hi = tio._geom_world_aabb(mj, g)
    for x in (lo[0], hi[0]):
      for y in (lo[1], hi[1]):
        corners[(round(float(x), 9), round(float(y), 9), round(float(hi[2]), 9))] += 1
  return np.asarray(sorted(k for k, v in corners.items() if v == 4))


def _on_a_corner(name: str, corner: np.ndarray) -> np.ndarray:
  """qpos0 with the robot moved (level, unturned) so that its box or hull
  geom (Go1's trunk, Asimov's left foot) sinks 5 mm into the terrain with
  its centre over `corner`; Go1 lies with its legs folded (thighs 1.2 rad,
  calves -2.7 rad)."""
  mj, _, _, _, ttp, tm = _models(name)
  tg = next(g for g in ttp.terrain_groups if g.robot_type in (6, 7))
  g = int(tg.robot_geoms[0])
  qpos = mj.qpos0.copy()
  if name == "go1":
    qpos[8::3], qpos[9::3] = 1.2, -2.7
  d = tio.make_data(ttp, tm, 1).replace(qpos=torch.as_tensor(qpos)[None])
  d = tk.kinematics(ttp, tm, d)
  pos, mat = d.geom_xpos[0, g].numpy(), d.geom_xmat[0, g].numpy()
  local = (tio._hull_vertices(mj, g) if tg.robot_type == 7
           else mj.geom_size[g] * np.asarray(np.meshgrid(*[[-1, 1]] * 3)).reshape(3, -1).T)
  bottom = (pos + local @ mat.T)[:, 2].min()
  qpos[:2] += corner[:2] - pos[:2]
  qpos[2] += corner[2] - bottom - 0.005
  return qpos


def _states(name: str, n: int, seed: int) -> np.ndarray:
  """The robot near seeded tiles' spawn origins and on their seams (every
  second env at a tile's edge or corner), turned and tilted, its root at
  its initial height over the terrain under it less 2-8 cm; every third
  env lower, so that the trunk (Go1) or the feet deep in the treads (the
  bipeds) meet the stairs' edges."""
  mj, origins, *_ = _models(name)
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  rows, cols = origins.shape[:2]
  tile = origins[rng.integers(3, rows, n), rng.integers(0, cols, n)]
  qpos[:, :2] = tile[:, :2] + rng.uniform(-1.5, 1.5, (n, 2))
  seam = np.arange(n) % 2 == 1
  qpos[seam, :2] = tile[seam, :2] + rng.choice([-4.0, 4.0], (seam.sum(), 2))
  qpos[seam, 1] = np.where(np.arange(seam.sum()) % 2 == 0, tile[seam, 1], qpos[seam, 1])
  sink = rng.uniform(0.02, 0.08, n)
  sink[::3] = 0.15 if name == "go1" else 0.12
  qpos[:, 2] = _terrain_height(mj, qpos[:, :2]) + qpos[:, 2] - sink
  euler = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-0.15, 0.15, n),
                    rng.uniform(-0.15, 0.15, n)], -1)
  qpos[:, 3:7] = Rotation.from_euler("zyx", euler).as_quat()[:, [3, 0, 1, 2]]
  qpos[:, 7:] += rng.normal(0.0, 0.1, (n, qpos.shape[1] - 7))
  if name != "asimov_toe":
    # Every fourth env: the trunk or the left foot on a corner where 4
    # coplanar boxes meet (16 candidates, 9 distinct points for 6 slots).
    corners = _four_box_corners(mj)
    for i in range(0, n, 4):
      qpos[i] = _on_a_corner(name, corners[rng.integers(len(corners))])
  return qpos


@pytest.mark.parametrize("name", NAMES)
def test_collision_on_the_whole_scene_matches_jax(name):
  mj, origins, jtp, jm, ttp, tm = _models(name)
  n = 12
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(_states(name, n, 4)))
  d = jax.jit(jax.vmap(lambda d: jkinematics(jtp, jm, d)))(d)
  want = jax.jit(jax.vmap(lambda d: jcoll.collision(jtp, jm, d)))(d)
  got = tcoll.collision(ttp, tm, tp.to_torch(tp.jax_data_arrays(d)))
  tp.check_terrain_slots(tp.contact_parts(got.contact), tp.contact_parts(want.contact), name)
  np.testing.assert_array_equal(got.ncon_dropped.numpy(), np.asarray(want.ncon_dropped))
  active = (got.contact.dist < got.contact.includemargin).sum(dim=1)
  # Most robots touch the terrain (one on a stair's edge may hang over the
  # lower tread).
  assert (active > 0).sum() >= 3 * n // 4, active
  if name != "asimov_toe":  # a box or hull group: 16 candidates for 6 slots
    assert got.ncon_dropped.sum() > 0
  if name == "go1":  # the trunk's box group has active contacts
    box = slice(ttp.ncon_max - 6, None)
    assert (got.contact.dist[:, box] < got.contact.includemargin[:, box]).any()


SLAB_XML = """
<mujoco>
  <option integrator="implicitfast"/>
  <worldbody>
    <geom name="slab" type="box" size="1.2 1.2 0.0173" pos="0 0 -0.0173"/>
    <body name="toe" pos="-1 0 0.00928" euler="0 40 0"><freejoint/>
      <geom name="toe" type="capsule" size="0.01 0.03"/>
    </body>
  </worldbody>
</mujoco>"""


def test_asimov_toe_capsule_contacts_come_from_above():
  """The Asimov-Toe rough task's declared divergence,
  `capsule_terrain_from_above`, on its toe capsule (radius 1 cm,
  half-length 3 cm) over a large stair slab (1.2 m, 3.46 cm thick):

  - tilted 40 degrees from upright, its lower end 2.4 cm deep on the side
    away from the slab's centre: the JAX package's capsule–box takes the
    segment point nearest the centre and the end beside it — both the
    higher end, 2.2 cm above the slab — and sees no contact (ROADMAP Queue
    C); the option's second contact is the lower end at MuJoCo's own depth
    (mj_forward on the same two geoms);
  - a sphere of it whose centre is 2 cm deep, past the slab's mid-plane:
    the JAX package's contact leaves through the bottom face (its normal
    points down, pulling the foot through); the option's through the top,
    3 cm deep.

  Without the option the port equals the JAX package (1e-12)."""
  import mujoco

  from mjlab_tpu.physics import collision as jcoll
  from mjlab_tpu_torch.tasks import load_env_cfg

  mj = mujoco.MjModel.from_xml_string(SLAB_XML)
  md = mujoco.MjData(mj)
  mujoco.mj_forward(mj, md)
  want = min(md.contact[i].dist for i in range(md.ncon))
  assert want < -0.019
  args = [md.geom_xpos[1], md.geom_xmat[1].reshape(3, 3), mj.geom_size[1],
          md.geom_xpos[0], md.geom_xmat[0].reshape(3, 3), mj.geom_size[0]]
  jd, jpos, jframe = jcoll._capsule_box(*map(jnp.asarray, args))
  t = [torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in args]
  ref = tcoll._capsule_box_normals(*t)
  tp.assert_close(ref[0].numpy(), jd, 1e-12, "dist")
  tp.assert_close(ref[1].numpy(), jpos, 1e-12, "pos")
  tp.assert_close(-ref[2].numpy(), np.asarray(jframe)[:, 0], 1e-12, "normal")
  assert (np.asarray(jd) > 0).all()  # the JAX package sees no contact
  above = tcoll._capsule_box_normals(*t, from_above=True)
  assert float(above[0][0]) == float(ref[0][0])
  np.testing.assert_allclose(float(above[0][1]), want, rtol=0, atol=1e-12)

  sphere = [np.array([0.3, 0.2, -0.02]), 0.01] + args[3:]
  jd, _, jn = jcoll._sphere_box_impl(*map(jnp.asarray, sphere))
  t = [torch.as_tensor(np.asarray(x, dtype=np.float64)) for x in sphere]
  ref = tcoll._sphere_box_impl(*t)
  tp.assert_close(ref[0].numpy(), jd, 1e-12, "dist")
  np.testing.assert_array_equal(ref[2].numpy(), jn)
  np.testing.assert_array_equal(np.asarray(jn), [0.0, 0.0, -1.0])  # down, through the bottom
  above = tcoll._sphere_box_impl(*t, from_above=True)
  np.testing.assert_allclose(float(above[0]), -0.03, rtol=0, atol=1e-12)
  np.testing.assert_array_equal(above[2].numpy(), [0.0, 0.0, 1.0])
  assert load_env_cfg("Mjlab-Velocity-Rough-Asimov-Toe").sim.capsule_terrain_from_above
  assert not any(load_env_cfg(task).sim.capsule_terrain_from_above
                 for task in ("Mjlab-Velocity-Rough-Unitree-Go1", "Mjlab-Velocity-Rough-Asimov",
                              "Mjlab-Velocity-Rough-Unitree-G1"))
