"""Model upload parity: the port's put_model against the JAX package's, on a
toy scene, on G1 velocity-flat and on the Asimov and Asimov-Toe
velocity-flat scenes (hulls and tendon maps included), and the committed
G1 npz's freshness (the Asimov npz files': tests/test_torch_asimov_model.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from mjlab_tpu_torch import assets
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.physics.types import Model, Option
from tests.torch_parity import g1_mj_model, jax_model_arrays, scene

SCENE_NAMES = ("toy", "g1", "asimov", "asimov_toe")


def _equal(a, b, what):
  a, b = np.asarray(a), np.asarray(b)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_topology_equal(name):
  sc = scene(name)
  for f in dataclasses.fields(sc.jtp):
    want, got = getattr(sc.jtp, f.name), getattr(sc.ttp, f.name)
    if f.name == "body_levels":
      assert len(got) == len(want)
      for g, w in zip(got, want):
        _equal(g, w, f.name)
    elif f.name == "pairs":
      assert [dataclasses.astuple(p) for p in got] == [
        dataclasses.astuple(p) for p in want
      ]
    elif f.name == "geom_hulls":
      assert sorted(got) == sorted(want)
      for g in want:
        for h in dataclasses.fields(want[g]):
          _equal(getattr(got[g], h.name), getattr(want[g], h.name), f"hull {g}.{h.name}")
    elif isinstance(want, np.ndarray):
      _equal(got, want, f.name)
    else:
      assert got == want or (not got and not want), f.name


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_model_leaves_equal(name):
  sc = scene(name)
  want = jax_model_arrays(sc.jm)
  got = {f: getattr(sc.tm, f) for f in tio.model_fields()}
  for f, v in got.items():
    _equal(v.numpy(), want[f], f)
  for f in dataclasses.fields(Option):
    v = getattr(sc.tm.opt, f.name)
    v = v.numpy() if isinstance(v, torch.Tensor) else v
    _equal(v, want[f"opt.{f.name}"], f"opt.{f.name}")


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_model_from_arrays_matches_put_model(name):
  sc = scene(name)
  arrays = jax_model_arrays(sc.jm)
  m = tio.model_from_arrays(arrays, dtype=torch.float64, device="cpu")
  for f in dataclasses.fields(Model):
    a, b = getattr(m, f.name), getattr(sc.tm, f.name)
    if f.name == "opt":
      for g in dataclasses.fields(Option):
        x, y = getattr(a, g.name), getattr(b, g.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), g.name
    else:
      assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_model_from_arrays_carries_randomized_leaf():
  sc = scene("g1")
  arrays = jax_model_arrays(sc.jm)
  rng = np.random.default_rng(3)
  arrays["geom_friction"] = arrays["geom_friction"] * rng.uniform(
    0.5, 1.5, arrays["geom_friction"].shape
  )
  m = tio.model_from_arrays(arrays, dtype=torch.float64, device="cpu")
  _equal(m.geom_friction.numpy(), arrays["geom_friction"], "geom_friction")


def test_npz_loads_like_the_live_model():
  """put_model on the committed npz gives the live model's Topology and
  Model (the GPU host's path)."""
  sc = scene("g1")
  tp, m = tio.put_model(assets.load_model_npz(), dtype=torch.float64, device="cpu")
  assert tp.ncon_max == sc.ttp.ncon_max == 533
  assert tp.nefc == sc.ttp.nefc == 1699
  assert [dataclasses.astuple(p) for p in tp.pairs] == [
    dataclasses.astuple(p) for p in sc.ttp.pairs
  ]
  for f in tio.model_fields():
    assert torch.equal(getattr(m, f), getattr(sc.tm, f)), f


def test_g1_npz_is_fresh(tmp_path):
  """The committed npz equals save_model_npz of a fresh G1 compile.

  Regenerate it with:
  PYTHONPATH=. JAX_PLATFORMS=cpu python -c "from tests.torch_parity import g1_mj_model; from mjlab_tpu_torch.assets import save_model_npz, G1_VELOCITY_FLAT; save_model_npz(g1_mj_model(), G1_VELOCITY_FLAT)"
  """
  fresh = tmp_path / "g1.npz"
  assets.save_model_npz(g1_mj_model(), fresh)
  with np.load(fresh) as a, np.load(assets.G1_VELOCITY_FLAT) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


@pytest.mark.parametrize(
  "xml_edit, feature",
  [
    ('iterations="10"', "PGS solver"),
    ('iterations="10"', "PGS with elliptic"),
    ('<joint name="j4" type="hinge"', "ball joints"),
    ('<body name="ball" pos="0.3 0.25 0.3">', "gravity compensation"),
  ],
)
def test_unsupported_features_raise(xml_edit, feature):
  """Features the port still refuses raise NotImplementedError naming them
  (RK4, CG, the elliptic cone and friction loss are ported: see
  tests/test_torch_solvers.py, test_torch_elliptic.py and
  test_torch_constraint_rows.py)."""
  import mujoco

  from tests.torch_parity import TOY_XML

  repl = {
    "PGS solver": 'iterations="10" solver="PGS"',
    "PGS with elliptic": 'iterations="10" solver="PGS" cone="elliptic"',
    "ball joints": '<joint name="j4" type="ball"',
    "gravity compensation": '<body name="ball" pos="0.3 0.25 0.3" gravcomp="1">',
  }[feature]
  xml = TOY_XML.replace(xml_edit, repl, 1)
  if feature == "ball joints":  # a ball joint takes no axis, and no actuator
    xml = xml.replace('type="ball" axis="1 0 0" range="-0.6 0.6"', 'type="ball"').replace(
      '<position joint="j4" kp="30"/>', "")
  m = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match=feature):
    tio.put_model(m, dtype=torch.float64, device="cpu")
