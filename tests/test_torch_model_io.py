"""Model upload parity: the port's put_model against the JAX package's, on a
toy scene, on G1 velocity-flat and on the Asimov and Asimov-Toe
velocity-flat scenes (hulls and tendon maps included), and the committed
G1 npz's freshness (the Asimov npz files': tests/test_torch_asimov_model.py)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
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
    ('iterations="10"', "PGS with elliptic"),
    ('<joint name="j4" type="hinge"', "ball joint stiffness"),
    ('iterations="10"', "noslip post-solver"),
  ],
)
def test_unsupported_features_raise(xml_edit, feature):
  """Features the port still refuses raise NotImplementedError naming them
  (PGS under the pyramidal cone: test_pgs_solver_equals_jax; RK4, CG, the
  elliptic cone and friction loss are ported: see
  tests/test_torch_solvers.py, test_torch_elliptic.py and
  test_torch_constraint_rows.py; ball joints and gravity compensation:
  tests/test_torch_ball_joints.py and test_torch_mocap_gravcomp.py)."""
  import mujoco

  from tests.torch_parity import TOY_XML

  repl = {
    "PGS with elliptic": 'iterations="10" solver="PGS" cone="elliptic"',
    "ball joint stiffness": '<joint name="j4" type="ball" stiffness="5"',
    "noslip post-solver": 'iterations="10" noslip_iterations="3"',
  }[feature]
  xml = TOY_XML.replace(xml_edit, repl, 1)
  if feature == "ball joint stiffness":  # a ball joint takes no axis, and no actuator
    xml = xml.replace('type="ball" stiffness="5" axis="1 0 0" range="-0.6 0.6"',
                      'type="ball" stiffness="5"').replace('<position joint="j4" kp="30"/>', "")
  m = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError, match=feature):
    tio.put_model(m, dtype=torch.float64, device="cpu")


def test_pgs_solver_equals_jax():
  """The toy scene (contacts, joint limits, no tendon) under
  solver="PGS" (pyramidal, 10 sweeps): put_model takes it, and one forward
  of its 8 recorded contact-rich states equals the JAX package's qacc,
  efc_force and qfrc_constraint within 1e-9 relative."""
  import jax
  import mujoco

  from mjlab_tpu import physics as jphysics
  from mjlab_tpu_torch import physics as tphysics
  from tests.torch_parity import TOY_XML, assert_close, jax_data_from_arrays, to_torch

  mj = mujoco.MjModel.from_xml_string(TOY_XML.replace('iterations="10"',
                                                      'iterations="10" solver="PGS"', 1))
  assert mj.opt.solver == mujoco.mjtSolver.mjSOL_PGS
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  assert tm.opt.solver == 0 and ttp.nefc == jtp.nefc
  states = scene("toy").states
  want = jax.jit(jax.vmap(lambda d: jphysics.forward(jtp, jm, d)))(jax_data_from_arrays(states))
  got = tphysics.forward(ttp, tm, to_torch(states))
  assert (got.efc_D > 0).any()
  for f in ("qacc", "efc_force", "qfrc_constraint"):
    assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), 1e-9, f)
