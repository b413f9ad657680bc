"""The plane–cylinder, plane–ellipsoid and height-field pairs of the PyTorch
port against the JAX package (float64, CPU), on the committed scenes of
mjlab_tpu_torch/assets/pair_scenes.py: each npz is fresh and gives the JAX
package's pair table; at 6 seeded worlds (each body moved and tilted) the
contacts (dist, pos, frame) equal the JAX package's `collision` to 1e-9,
and one substep's qpos and qvel equal its `step` to 1e-8, or twice the JAX
package's own spread under 2 qpos nudges of 1e-13 where that is larger (the
repo's rule for ill-conditioned solves: a light ellipsoid's rotation barely
moves the solver's cost).

Regenerate the files with:
PYTHONPATH=. JAX_PLATFORMS=cpu python -c "import mujoco; from mjlab_tpu_torch.assets import save_model_npz; from mjlab_tpu_torch.assets.pair_scenes import SCENES; [save_model_npz(mujoco.MjModel.from_xml_string(s.xml), s.path(n)) for n, s in SCENES.items()]"
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch import physics as tphysics
from mjlab_tpu_torch.assets import pair_scenes
from mjlab_tpu_torch.physics import io as tio
from torch_parity import assert_close, jax_data_arrays, jax_data_from_arrays, to_torch, \
  torch_threads

WORLDS = 6
NUDGES = 2
CONTACT_TOL = 1e-9
STEP_TOL = 1e-8
PAIR_KEYS = {
  "plane_cylinder": {(0, 5)},
  "plane_ellipsoid": {(0, 4)},
  "hfield": {(1, 2), (1, 3), (1, 6), (1, 7)},
}


@functools.lru_cache(maxsize=None)
def _scene(name: str):
  """(JAX Topology, JAX Model, port Topology, port Model from the npz, the
  seeded worlds' states as arrays, the JAX package's substep from them and
  from NUDGES nudged copies, all by name). A JAX Data after `step` holds
  the contacts of the forward it started from, so one compile serves both
  tests."""
  sc = pair_scenes.SCENES[name]
  mj = mujoco.MjModel.from_xml_string(sc.xml)
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  ttp, tm = tio.put_model(pair_scenes.load(name), dtype=torch.float64, device="cpu")
  rng = np.random.default_rng(sorted(pair_scenes.SCENES).index(name))
  q = np.tile(mj.qpos0, (WORLDS, 1))
  for b in range(mj.nbody - 1):  # every body is a free body: move and tilt it
    q[:, 7 * b : 7 * b + 2] += rng.uniform(-0.15, 0.15, (WORLDS, 2))
    q[:, 7 * b + 2] += rng.uniform(-0.01, 0.004, WORLDS)
    quat = q[:, 7 * b + 3 : 7 * b + 7] + rng.normal(0, 0.1, (WORLDS, 4))
    q[:, 7 * b + 3 : 7 * b + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  d0 = jphysics.make_data(jtp, jm)
  states = jax_data_arrays(jax.vmap(lambda qq, vv: d0.replace(qpos=qq, qvel=vv))(
    jnp.asarray(q), jnp.asarray(np.tile(np.asarray(sc.qvel), (WORLDS, 1)))))
  step = jax.jit(jax.vmap(lambda d: jphysics.step(jtp, jm, d)))
  want = jax_data_arrays(step(jax_data_from_arrays(states)))
  spread = [jax_data_arrays(step(jax_data_from_arrays(dict(states, qpos=states["qpos"] * (
    1 + 1e-13 * rng.normal(size=states["qpos"].shape)))))) for _ in range(NUDGES)]
  return jtp, jm, ttp, tm, states, want, spread


@pytest.mark.parametrize("name", sorted(pair_scenes.SCENES))
def test_npz_is_fresh(name, tmp_path):
  sc = pair_scenes.SCENES[name]
  fresh = tmp_path / f"{name}.npz"
  assets.save_model_npz(mujoco.MjModel.from_xml_string(sc.xml), fresh)
  with np.load(fresh) as a, np.load(sc.path(name)) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


@pytest.mark.parametrize("name", sorted(pair_scenes.SCENES))
def test_pair_table_equals_jax(name):
  """The npz's pair table, row count and height-field leaves are the JAX
  package's, and every pair kind the scene is for is in it."""
  jtp, jm, ttp, tm, *_ = _scene(name)
  assert [dataclasses.astuple(p) for p in ttp.pairs] == [
    dataclasses.astuple(p) for p in jtp.pairs]
  assert (ttp.ncon_max, ttp.nefc, ttp.nhfield) == (jtp.ncon_max, jtp.nefc, jtp.nhfield)
  assert PAIR_KEYS[name] <= {(p.type1, p.type2) for p in ttp.pairs}
  for f in ("hfield_data", "hfield_size"):
    np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
  for f in ("hfield_nrow", "hfield_ncol", "hfield_adr"):
    np.testing.assert_array_equal(getattr(ttp, f), getattr(jtp, f))


@pytest.mark.parametrize("name", sorted(pair_scenes.SCENES))
def test_contacts_equal_jax(name):
  """Every slot's dist, pos and frame (and its parameters) at the seeded
  worlds, and every world with an active slot."""
  jtp, jm, ttp, tm, states, want, _ = _scene(name)
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.forward(ttp, tm, to_torch(states)))
  for f in ("dist", "pos", "frame", "includemargin", "friction", "solref", "solimp"):
    f = f"contact.{f}"
    assert_close(got[f], want[f], CONTACT_TOL, f"{name}: {f}")
  active = want["contact.dist"] < want["contact.includemargin"]
  assert active.any(axis=1).all(), active.sum(axis=1)


@pytest.mark.parametrize("name", sorted(pair_scenes.SCENES))
def test_substep_equals_jax(name):
  jtp, jm, ttp, tm, states, want, spread = _scene(name)
  with torch_threads(1):
    got = tio.data_to_arrays(tphysics.step(ttp, tm, to_torch(states)))
  for f in ("qpos", "qvel"):
    scale = max(1.0, float(np.max(np.abs(want[f]))))
    far = max(float(np.max(np.abs(s[f] - want[f]))) for s in spread)
    assert_close(got[f], want[f], max(STEP_TOL, 2 * far / scale), f"{name}: {f}")
