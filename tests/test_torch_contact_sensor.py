"""The port's contact sensor (mjlab_tpu_torch/sensors/contact_sensor.py)
against the JAX package's, on the scenes of tests/test_contact_sensor.py: a
box dropped on a plane, a box spun on a condim-4 elliptic floor (torsion),
and a two-footed body of spheres. The JAX package steps each scene (float64,
2 worlds); its state is carried into the port, and both sensors are read
on it: every field (found, force, torque, dist, pos, normal, tangent)
under every reduce (none, mindist, maxforce, netforce), in the contact frame
and with `global_frame`, within 1e-9 (under maxforce, slots whose normal
forces tie within rounding may be picked by either engine: `_check_maxforce`);
and the air-time state machine over a drop and two hops."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from mjlab_tpu.sensors import ContactMatch as JaxMatch
from mjlab_tpu.sensors import ContactSensorCfg as JaxSensorCfg
from mjlab_tpu_torch.physics import constraint as tconstraint
from mjlab_tpu_torch.physics import io as tio
from mjlab_tpu_torch.sensors import ContactMatch, ContactSensorCfg
from tests.test_contact_sensor import BOX_XML, SPIN_XML, TWO_FEET_XML, _Ctx
from tests.torch_parity import assert_close, jax_data_arrays

TOL = 1e-9
FIELDS = ("found", "force", "torque", "dist", "pos", "normal", "tangent")
REDUCES = ("none", "mindist", "maxforce", "netforce")


class PortCtx:
  """The state context the port's sensors read, on a JAX context's model
  and (carried) state."""

  def __init__(self, jctx: _Ctx):
    self.mj = jctx.sim.mj_model
    self.tp, self.model = tio.put_model(self.mj, dtype=torch.float64, device="cpu")
    self.num_envs, self.dtype, self.device = jctx.num_envs, torch.float64, torch.device("cpu")
    self._ms = {"scene": {"sensors": {}}}
    self.data = None

  def ns(self, name):
    return self._ms.setdefault(name, {})

  def carry(self, jctx: _Ctx) -> None:
    arrays = jax_data_arrays(jctx.data)
    self.data = tio.data_from_arrays(
      {k: v for k, v in arrays.items() if v.dtype != object}, dtype=torch.float64,
      device="cpu")

  def contact_forces(self):
    return tconstraint.contact_forces(self.tp, self.model, self.data)

  def make_sensor(self, cfg: ContactSensorCfg):
    sensor = cfg.build()
    sensor.initialize(self.mj, self)
    self._ms["scene"]["sensors"][cfg.name] = sensor.init_state()
    return sensor


# name: (xml, primary, secondary, steps before the read, spin)
SCENES = {
  "box": (BOX_XML, ("geom", "box_geom"), ("geom", "floor"), 200, 0.0),  # settled
  "spin": (SPIN_XML, ("geom", "box_geom"), None, 10, 4.0),  # spinning
  "feet": (TWO_FEET_XML, ("subtree", "(left|right)_foot"), ("geom", ".*"), 300, 0.0),
}


@functools.lru_cache(maxsize=None)
def scene_states(name: str):
  """The JAX context and its state at the read (in contact)."""
  xml, *_, steps, spin = SCENES[name]
  jctx = _Ctx(xml=xml)
  jctx.data = jctx.sim.make_data()
  if spin:
    jctx.data = jctx.data.replace(qvel=jctx.data.qvel.at[:, 5].set(spin))
  jctx.step(steps)
  return jctx, [jctx.data]


def _cfgs(name: str, reduce: str, global_frame: bool):
  _, (pmode, ppat), second, *_ = SCENES[name]

  def cfg(cls, match):
    return cls(
      name=f"{name}_{reduce}_{global_frame}",
      primary=match(mode=pmode, pattern=ppat),
      secondary=None if second is None else match(mode=second[0], pattern=second[1]),
      fields=FIELDS, reduce=reduce, global_frame=global_frame,
    )

  return cfg(JaxSensorCfg, JaxMatch), cfg(ContactSensorCfg, ContactMatch)


@pytest.mark.parametrize("global_frame", [False, True])
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_fields_and_reduces_match_jax(name, reduce, global_frame):
  jctx, states = scene_states(name)
  ctx = PortCtx(jctx)
  jcfg, tcfg = _cfgs(name, reduce, global_frame)
  js, ts = jctx.make_sensor(jcfg), ctx.make_sensor(tcfg)
  assert ts.item_names == js.item_names
  np.testing.assert_array_equal(ts._slot_idx, js._slot_idx)
  np.testing.assert_array_equal(ts._slot_sign, js._slot_sign)
  for k, state in enumerate(states):
    jctx.data = state
    ctx.carry(jctx)
    want, got = js.data, ts.data
    what = f"{name} {reduce} {global_frame} read {k}"
    assert np.asarray(want.found).max() >= 1  # the read sees contacts
    for f in FIELDS:
      assert (getattr(want, f) is None) == (getattr(got, f) is None), f
    if reduce == "maxforce":
      for out in (want, got):
        _check_maxforce(jctx, js, out, global_frame, what)
      continue
    for f in FIELDS:
      assert_close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), TOL, f"{what}: {f}")


def _check_maxforce(jctx, js, out, global_frame: bool, what: str) -> None:
  """maxforce picks the slot of largest normal force; where slots tie within
  rounding (a box's four settled corners) either engine may pick any of
  them. So each item's outputs (`out`, either engine's) must equal those of
  one slot of its tie set, every output taken from the JAX package's own
  slot quantities."""
  d = jctx.data
  idx, sign = js._slot_idx, js._slot_sign
  dist = np.asarray(d.contact.dist)[:, idx]
  active = (dist < np.asarray(d.contact.includemargin)[:, idx]) & js._slot_valid
  w = np.asarray(jctx.contact_forces())[:, idx] * active[..., None]  # (B, N, S, 6)
  frames = np.asarray(d.contact.frame)[:, idx]
  force, torque = w[..., :3], w[..., 3:]
  if global_frame:
    force = np.einsum("bnsi,bnsij->bnsj", force, frames) * sign[..., None]
    torque = np.einsum("bnsi,bnsij->bnsj", torque, frames) * sign[..., None]
  slot = {"force": force, "torque": torque, "dist": dist,
          "pos": np.asarray(d.contact.pos)[:, idx],
          "normal": frames[..., 0, :] * sign[..., None], "tangent": frames[..., 1, :]}
  fn = np.where(active, np.abs(w[..., 0]), -np.inf)
  top = fn.max(axis=-1, keepdims=True)
  ties = active & (fn >= top - TOL * max(1.0, float(np.max(np.abs(w)))))
  np.testing.assert_array_equal(np.asarray(out.found), active.sum(-1))
  for b, n in np.ndindex(ties.shape[:2]):
    def matches(s):
      return all(np.allclose(np.asarray(getattr(out, f))[b, n], slot[f][b, n, s], rtol=0,
                             atol=TOL * max(1.0, float(np.max(np.abs(slot[f])))))
                 for f in slot)
    assert any(matches(s) for s in np.nonzero(ties[b, n])[0]), f"{what}: item {b}, {n}"


def test_torsion_and_world_force_are_physical():
  """The spun box's torsional torque opposes the spin, and the settled box's
  world-frame maxforce is upward and below its weight (the behaviours
  tests/test_contact_sensor.py states), read through the port."""
  jctx, states = scene_states("spin")
  ctx = PortCtx(jctx)
  jctx.data = states[0]
  ctx.carry(jctx)
  spin = ctx.make_sensor(_cfgs("spin", "maxforce", False)[1])
  assert (spin.data.torque[:, 0, 0] < -1e-4).all()
  jctx, states = scene_states("box")
  ctx = PortCtx(jctx)
  jctx.data = states[-1]
  ctx.carry(jctx)
  box = ctx.make_sensor(_cfgs("box", "maxforce", True)[1])
  weight = float(ctx.mj.body("box").mass[0]) * 9.81
  f = box.data.force[:, 0]
  assert (f[:, 2] > 0.2 * weight).all() and (f[:, 2] <= 1.05 * weight).all()
  assert (f[:, :2].abs() < 0.05 * weight).all()


def test_air_time_matches_jax():
  """Drop, land and two relaunches of the box (in both worlds of the box
  scene's context): the port's air-time state and its first-contact /
  first-air flags against JAX's after every step, the JAX state carried
  in before each update; then a masked reset."""
  dt = 0.005
  jctx, _ = scene_states("box")
  ctx = PortCtx(jctx)

  def cfg(cls, match):
    return cls(name="hop", primary=match(mode="geom", pattern="box_geom"), fields=("found",),
               reduce="none", track_air_time=True)

  js, ts = jctx.make_sensor(cfg(JaxSensorCfg, JaxMatch)), ctx.make_sensor(
    cfg(ContactSensorCfg, ContactMatch))
  jctx.data = jctx.sim.make_data()
  landings = 0
  for i in range(150):
    jctx.step(1)
    ctx.carry(jctx)
    js.update(dt)
    ts.update(dt)
    for k, v in js.state.items():
      assert_close(ts.state[k].numpy(), np.asarray(v), 1e-12, f"step {i} {k}")
    for fn in ("compute_first_contact", "compute_first_air"):
      np.testing.assert_array_equal(getattr(ts, fn)(dt).numpy(), np.asarray(getattr(js, fn)(dt)))
    if bool(np.asarray(js.compute_first_contact(dt)).all()):
      landings += 1
      if landings <= 2:
        jctx.data = jctx.data.replace(qvel=jctx.data.qvel.at[:, 2].set(1.2))
  assert landings == 3
  mask = np.array([True, False])
  js.reset(jax.numpy.asarray(mask))
  ts.reset(torch.as_tensor(mask))
  for k, v in js.state.items():
    assert_close(ts.state[k].numpy(), np.asarray(v), 0.0, f"reset {k}")
