"""Model upload of the Asimov scenes: the port's put_model against the JAX
package's on the Asimov and Asimov-Toe velocity-flat scenes (topology with
the mesh hulls and the tendon and transmission matrices, model leaves),
from the live model and from the committed npz, the npz files' freshness
and size, and the features put_model keeps refusing."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import convex as tconvex
from mjlab_tpu_torch.physics import io as tio
from tests.torch_parity import (
  asimov_mj_model,
  asimov_toe_mj_model,
  scene,
)

NAMES = ("asimov", "asimov_toe")
NPZ = {"asimov": assets.ASIMOV_VELOCITY_FLAT, "asimov_toe": assets.ASIMOV_TOE_VELOCITY_FLAT}
LIVE = {"asimov": asimov_mj_model, "asimov_toe": asimov_toe_mj_model}


def _equal(a, b, what):
  a, b = np.asarray(a), np.asarray(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", NAMES)
def test_topology_from_the_npz_equals_jax(name):
  """put_model of the committed npz, where the hulls come from its packed
  hull vertices, gives every Topology field of the JAX package's put_model
  of the live model (which tests/test_torch_model_io.py holds for the
  port's put_model of the live model)."""
  sc = scene(name)
  ttp, _ = tio.put_model(assets.load_model_npz(NPZ[name]), dtype=torch.float64,
                         device="cpu")
  for f in dataclasses.fields(sc.jtp):
    w, g = getattr(sc.jtp, f.name), getattr(ttp, f.name)
    if f.name == "body_levels":
      assert all(np.array_equal(x, y) for x, y in zip(g, w, strict=True))
    elif f.name == "pairs":
      assert [dataclasses.astuple(p) for p in g] == [dataclasses.astuple(p) for p in w]
    elif f.name == "geom_hulls":
      assert sorted(g) == sorted(w)
      for k in w:
        for h in dataclasses.fields(w[k]):
          _equal(getattr(g[k], h.name), getattr(w[k], h.name), f"hull {k}.{h.name}")
    elif isinstance(w, np.ndarray):
      _equal(g, w, f.name)
    else:
      assert g == w or (not g and not w), f.name


def test_scene_sizes():
  """The shapes these scenes give the physics and the kernels."""
  a, t = scene("asimov").ttp, scene("asimov_toe").ttp
  assert (a.nq, a.nv, a.nu, a.ntendon, a.nefc, a.ncon_max) == (19, 18, 12, 0, 44, 8)
  assert (t.nq, t.nv, t.nu, t.ntendon, t.nefc, t.ncon_max) == (21, 20, 14, 4, 174, 40)
  assert {(p.type1, p.type2) for p in a.pairs} == {(0, 7)}
  assert sorted(a.geom_hulls) == [7, 13]
  assert all(h.verts.shape == (32, 3) for h in a.geom_hulls.values())
  assert t.geom_hulls == {} and {(p.type1, p.type2) for p in t.pairs} == {(0, 3)}


def test_toe_tendon_and_transmission_matrices():
  """The fixed tendons' rows carry their joint coefficients (±0.09 on the
  ankle pitch, ±0.02 on the roll); the 4 tendon actuators' rows are their
  tendons' (gear 1)."""
  tp = scene("asimov_toe").ttp
  assert np.count_nonzero(tp.tendon_vmat) == 8
  assert sorted(set(np.abs(tp.tendon_vmat[tp.tendon_vmat != 0]).round(6))) == [0.02, 0.09]
  _equal(tp.trn_vmat[:4], tp.tendon_vmat, "tendon actuator rows")
  assert np.all(tp.trn_vmat[4:].sum(axis=1) == 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_npz_is_fresh_and_small(name, tmp_path):
  """The committed npz equals save_model_npz of a fresh compile, and stays
  under 1 MB.

  Regenerate both with:
  PYTHONPATH=. JAX_PLATFORMS=cpu python -c "from tests.torch_parity import asimov_mj_model, asimov_toe_mj_model; from mjlab_tpu_torch import assets; assets.save_model_npz(asimov_mj_model(), assets.ASIMOV_VELOCITY_FLAT); assets.save_model_npz(asimov_toe_mj_model(), assets.ASIMOV_TOE_VELOCITY_FLAT)"
  """
  fresh = tmp_path / "scene.npz"
  assets.save_model_npz(LIVE[name](), fresh)
  with np.load(fresh) as a, np.load(NPZ[name]) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k
  assert NPZ[name].stat().st_size < 1_000_000


@pytest.mark.parametrize("name", NAMES)
def test_npz_keeps_what_the_port_reads(name):
  """The trimmed npz drops every mesh_* and bvh_* array, keeps every other
  array of the live model unchanged, and rewrites to itself (the NaN
  guard's model.npz path)."""
  live = LIVE[name]()
  arrays = assets.model_arrays(live)
  assert not [k for k in arrays if k.startswith(("mesh_", "bvh_"))]
  for k, v in arrays.items():
    if hasattr(live, k) and k != "names":
      _equal(v, np.asarray(getattr(live, k)), k)
  again = assets.model_arrays(assets.load_model_npz(NPZ[name]))
  assert sorted(again) == sorted(arrays)
  for k in arrays:
    _equal(again[k], arrays[k], k)


def test_hull_vertices_from_npz_are_the_live_models():
  """The feet's hull vertices in the npz are what the qhull graph gives
  (1195 per foot), and build_hull makes the JAX package's hull of them."""
  from mjlab_tpu.physics.convex import build_hull as jax_build_hull
  from mjlab_tpu.physics.io import _hull_vertices as jax_hull_vertices

  live = asimov_mj_model()
  npz = assets.load_model_npz(assets.ASIMOV_VELOCITY_FLAT)
  for g in (7, 13):
    v = tio._hull_vertices(npz, g)
    assert v.shape == (1195, 3)
    _equal(v, jax_hull_vertices(live, g), f"geom {g}")
    got, want = tconvex.build_hull(v), jax_build_hull(v)
    for h in dataclasses.fields(want):
      _equal(getattr(got, h.name), getattr(want, h.name), h.name)


def test_chip_smoke_hull_digest_is_this_hosts():
  """chip_smoke.py holds the hulls that put_model builds from the npz on
  the card's host (its scipy may differ in version) to the digest of the
  hulls built here, which are the JAX package's."""
  tp, _ = tio.put_model(assets.load_model_npz(assets.ASIMOV_VELOCITY_FLAT),
                        dtype=torch.float64, device="cpu")
  assert chip_smoke.hull_digest(tp) == chip_smoke.ASIMOV_HULL_DIGEST
  assert chip_smoke.hull_digest(scene("asimov").jtp) == chip_smoke.ASIMOV_HULL_DIGEST


_TENDON_XML = """
<mujoco>
  <option integrator="implicitfast"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="a" pos="0 0 1">
      <freejoint/>
      <geom type="sphere" size="0.1"/>
      <site name="s0"/>
      <body name="b" pos="0.3 0 0">
        <joint name="j" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.05" fromto="0 0 0 0.2 0 0"/>
        <site name="s1" pos="0.2 0 0"/>
      </body>
    </body>
  </worldbody>
  TENDON
  SENSOR
</mujoco>
"""


@pytest.mark.parametrize(
  "tendon, sensor, feature",
  [
    ('<tendon><spatial name="t"><site site="s0"/><site site="s1"/></spatial></tendon>',
     "", "spatial tendon"),
    ('<tendon><fixed name="t"><joint joint="j" coef="1"/></fixed></tendon>',
     '<sensor><tendonpos tendon="t"/></sensor>', "sensor type"),
    ("", '<sensor><framepos objtype="site" objname="s1" reftype="site" refname="s0"/>'
     "</sensor>", "reference frame"),
  ],
)
def test_unsupported_tendons_and_sensors_raise(tendon, sensor, feature):
  import mujoco

  xml = _TENDON_XML.replace("TENDON", tendon).replace("SENSOR", sensor)
  m = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match=feature):
    tio.put_model(m, dtype=torch.float64, device="cpu")


def test_mesh_pairs_other_than_plane_mesh_raise():
  """With contype 1 on the left foot, the two foot meshes form a mesh–mesh
  pair. It raised until the port had the hull SAT; now both packages build
  it (4 slots, 89 x 89 edge pairs over the budget: no edge axes), and the
  narrowphase's parity is tests/test_torch_convex.py's."""
  import jax.numpy as jnp

  from mjlab_tpu import physics as jphysics

  m = asimov_mj_model()
  m.geom_contype[7] = 1
  ttp, _ = tio.put_model(m, dtype=torch.float64, device="cpu")
  jtp, _ = jphysics.put_model(m, dtype=jnp.float64)
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [dataclasses.astuple(p) for p in jtp.pairs]
  assert (7, 13, 7, 7, 4) in [(p.geom1, p.geom2, p.type1, p.type2, p.ncon) for p in ttp.pairs]
  assert (ttp.ncon_max, ttp.nefc) == (jtp.ncon_max, jtp.nefc)
