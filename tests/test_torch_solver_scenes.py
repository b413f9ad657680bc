"""The solver surface's committed scenes (mjlab_tpu_torch/assets/solver/*.npz,
mjlab_tpu_torch/assets/solver_scenes.py): each is fresh, and put_model on
it gives the JAX package's Topology (the row counts of every kind) and the
live model's Model, under each of the scene's cones.

Regenerate the files with:
PYTHONPATH=. JAX_PLATFORMS=cpu python -c "import mujoco; from mjlab_tpu_torch.assets import save_model_npz; from mjlab_tpu_torch.assets.solver_scenes import SCENES; [save_model_npz(mujoco.MjModel.from_xml_string(s.xml), s.path(n)) for n, s in SCENES.items()]"
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu import physics as jphysics
from mjlab_tpu_torch import assets
from mjlab_tpu_torch.assets import solver_scenes
from mjlab_tpu_torch.physics import io as tio

CASES = [(n, c) for n, s in solver_scenes.SCENES.items() for c in s.cones]


@pytest.mark.parametrize("name", sorted(solver_scenes.SCENES))
def test_npz_is_fresh(name, tmp_path):
  sc = solver_scenes.SCENES[name]
  fresh = tmp_path / f"{name}.npz"
  assets.save_model_npz(mujoco.MjModel.from_xml_string(sc.xml), fresh)
  with np.load(fresh) as a, np.load(sc.path(name)) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
      assert a[k].dtype == b[k].dtype, k
      assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


@pytest.mark.parametrize("name, cone", CASES)
def test_npz_topology_equals_jax(name, cone):
  live = mujoco.MjModel.from_xml_string(solver_scenes.SCENES[name].xml)
  for k, v in solver_scenes.SCENES[name].opt.items():
    setattr(live.opt, k, v)
  live.opt.cone = cone
  jtp, _ = jphysics.put_model(live, dtype=jnp.float64)
  tp, m = tio.put_model(solver_scenes.load(name, cone), dtype=torch.float64, device="cpu")
  _, m_live = tio.put_model(live, dtype=torch.float64, device="cpu")
  for f in ("nefc", "neq_rows", "ncon_max", "na"):
    assert getattr(tp, f) == getattr(jtp, f), f
  for f in ("friction_dof_ids", "limited_joint_ids", "limited_tendon_ids", "eq_type",
            "eq_obj1id", "eq_obj2id", "eq_objtype", "eq_active0", "tendon_invweight0"):
    assert np.array_equal(getattr(tp, f), getattr(jtp, f)), f
  assert [dataclasses.astuple(p) for p in tp.pairs] == [dataclasses.astuple(p) for p in jtp.pairs]
  for f in tio.model_fields():
    assert torch.equal(getattr(m, f), getattr(m_live, f)), f
  assert m.opt.cone == cone and m.opt.integrator == m_live.opt.integrator
