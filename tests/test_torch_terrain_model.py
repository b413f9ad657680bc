"""The G1 rough scene (Mjlab-Velocity-Rough-Unitree-G1) in the PyTorch port
against the JAX package (float64, CPU): the port's put_model on the
committed npz against the JAX package's on a fresh compile — the terrain
groups (cells, grid corner, robot geoms and radii, condim), the 469 static
pairs, 667 contact slots, 2235 Newton rows and the slot tables, array for
array; the committed rough and play npz files' freshness with their tile
origins; and `collision` on the whole scene from the JAX package's geom
poses (1e-9, the dropped counts exact)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from mjlab_tpu import physics as jphysics
from mjlab_tpu.physics import collision as jcoll
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics.kinematics import kinematics as jkinematics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import collision as tcoll
from mjlab_tpu_torch.physics import constraint as tcon
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import ConeType


@pytest.fixture(scope="module")
def models():
  mj, origins = tp.rough_scene("g1")
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(assets.load_model_npz(assets.G1_VELOCITY_ROUGH),
                          dtype=torch.float64, device="cpu")
  return mj, origins, jtp, jm, ttp, tm


def test_topology_counts(models):
  *_, jtp, _, ttp, _ = models
  assert (ttp.ncon_max, ttp.nefc, len(ttp.pairs)) == (jtp.ncon_max, jtp.nefc, len(jtp.pairs))
  assert (ttp.ncon_max, ttp.nefc, len(ttp.pairs)) == (667, 2235, 469)
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [
    dataclasses.astuple(p) for p in jtp.pairs
  ]


def test_terrain_groups_equal(models):
  *_, jtp, _, ttp, _ = models
  assert [(g.robot_type, len(g.robot_geoms)) for g in ttp.terrain_groups] == [(2, 2), (3, 31)]
  assert ttp.terrain_groups[0].cells.shape == (120, 200, 13)
  assert len(ttp.terrain_groups[0].pool_geoms) == 3564
  for got, want in zip(ttp.terrain_groups, jtp.terrain_groups, strict=True):
    for f in dataclasses.fields(want):
      x, y = getattr(got, f.name), getattr(want, f.name)
      if isinstance(y, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), f.name
      else:
        assert x == y, f.name


@pytest.mark.parametrize("cone", [ConeType.PYRAMIDAL])
def test_slot_tables_equal(models, cone):
  *_, jtp, _, ttp, _ = models
  got, want = tcon.slot_tables(ttp, cone), jcon.slot_tables(jtp, cone)
  for f in dataclasses.fields(want):
    np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                  np.asarray(getattr(want, f.name)), err_msg=f.name)
  assert got.nrow_contact == ttp.nefc - len(ttp.limited_joint_ids)


@pytest.mark.parametrize("play", [False, True], ids=["rough", "play"])
def test_npz_is_fresh(play, tmp_path):
  """The committed npz equals save_model_npz of a fresh compile with its
  tile origins (the play scene: the JAX package's play overrides, 3 x 3
  tiles without the curriculum).

  Regenerate both with:
  PYTHONPATH=.:tests JAX_PLATFORMS=cpu python -c "import torch_parity as tp; [tp.save_rough_npz('g1', p) for p in (False, True)]"
  """
  path = assets.G1_VELOCITY_ROUGH_PLAY if play else assets.G1_VELOCITY_ROUGH
  mj, origins = tp.rough_scene("g1", play)
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
  if play:
    assert tio.put_model(ns, dtype=torch.float64, device="cpu")[0].terrain_groups


def _states(mj, origins, n: int, seed: int) -> np.ndarray:
  """The robot near seeded tiles' spawn origins, at its initial height less
  2-8 cm (feet in the treads), turned and tilted a little."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  rows, cols = origins.shape[:2]
  tile = origins[rng.integers(0, rows, n), rng.integers(0, cols, n)]
  qpos[:, :2] = tile[:, :2] + rng.uniform(-1.0, 1.0, (n, 2))
  qpos[:, 2] = tile[:, 2] + qpos[:, 2] - rng.uniform(0.02, 0.08, n)
  half = rng.uniform(-0.1, 0.1, (n, 3)) / 2
  qpos[:, 3:7] = np.concatenate([np.ones((n, 1)), half], -1)
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
  qpos[:, 7:] += rng.normal(0.0, 0.1, (n, qpos.shape[1] - 7))
  return qpos


def test_collision_on_the_whole_scene_matches_jax(models):
  mj, origins, jtp, jm, ttp, tm = models
  n = 6
  d0 = jphysics.make_data(jtp, jm)
  d = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), d0)
  d = d.replace(qpos=jnp.asarray(_states(mj, origins, n, 4)))
  d = jax.jit(jax.vmap(lambda d: jkinematics(jtp, jm, d)))(d)
  want = jax.jit(jax.vmap(lambda d: jcoll.collision(jtp, jm, d)))(d)
  got = tcoll.collision(ttp, tm, tp.to_torch(tp.jax_data_arrays(d)))
  for f in dataclasses.fields(got.contact):
    tp.assert_close(getattr(got.contact, f.name).numpy(),
                    np.asarray(getattr(want.contact, f.name)), 1e-9, f.name)
  np.testing.assert_array_equal(got.ncon_dropped.numpy(), np.asarray(want.ncon_dropped))
  c = got.contact
  terrain = slice(sum(p.ncon for p in ttp.pairs), None)
  active = (c.dist[:, terrain] < c.includemargin[:, terrain]).sum(dim=1)
  assert (active > 0).all(), active  # every robot stands in the terrain
