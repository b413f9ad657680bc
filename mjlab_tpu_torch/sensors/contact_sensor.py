"""Contact sensor over the static contact-slot table (port of
mjlab_tpu/sensors/contact_sensor.py).

At initialize the (primary × secondary) matches resolve, from the compiled
model's names table, to static contact-slot index sets of the engine's
pair table: one row of slot indices, validity and sign per primary item.
Every step reduces over them with fixed shapes. Fields: found, force,
torque, dist, pos, normal, tangent. Reduces: "none" (the first active
slot), "mindist" (the nearest valid slot), "maxforce" (the active slot of
largest normal force) and "netforce" (the world-frame net wrench on the
primary, its torque about the active contacts' centroid). Forces are in the
selected contact's frame unless `global_frame`. The air-time state machine
is kept in the scene namespace.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.entity.entity import element_name
from mjlab_tpu_torch.sensors.sensor import Sensor, SensorCfg

@dataclass
class ContactMatch:
  """One side of a contact match."""

  mode: Literal["geom", "body", "subtree"]
  pattern: str | tuple[str, ...]
  entity: str | None = None
  exclude: tuple[str, ...] = ()


@dataclass
class ContactSensorCfg(SensorCfg):
  primary: ContactMatch = None  # type: ignore[assignment]
  secondary: ContactMatch | None = None
  fields: tuple[str, ...] = ("found", "force")
  reduce: Literal["none", "mindist", "maxforce", "netforce"] = "maxforce"
  track_air_time: bool = False
  global_frame: bool = False

  def build(self) -> "ContactSensor":
    return ContactSensor(self)


@dataclass
class ContactData:
  found: torch.Tensor | None = None  # [B, N]
  force: torch.Tensor | None = None  # [B, N, 3]
  torque: torch.Tensor | None = None  # [B, N, 3] torsion/rolling (condim ≥ 4)
  dist: torch.Tensor | None = None  # [B, N]
  pos: torch.Tensor | None = None  # [B, N, 3]
  normal: torch.Tensor | None = None  # [B, N, 3]
  tangent: torch.Tensor | None = None  # [B, N, 3]
  current_air_time: torch.Tensor | None = None
  last_air_time: torch.Tensor | None = None
  current_contact_time: torch.Tensor | None = None
  last_contact_time: torch.Tensor | None = None


def _match_names(patterns, names, exclude):
  if isinstance(patterns, str):
    patterns = (patterns,)
  pats = [re.compile(p) for p in patterns]
  exc = [re.compile(p) for p in exclude]
  return [
    n for n in names
    if any(p.fullmatch(n) for p in pats) and not any(e.fullmatch(n) for e in exc)
  ]


def _is_in_subtree(body_parentid, body: int, root: int) -> bool:
  b = body
  while True:
    if b == root:
      return True
    if b == 0:
      return False
    b = int(body_parentid[b])


class ContactSensor(Sensor[ContactData]):
  def __init__(self, cfg: ContactSensorCfg) -> None:
    self.cfg = cfg

  # -- resolution ---------------------------------------------------------------

  def _resolve_items(self, model, match: ContactMatch) -> list[tuple[str, set]]:
    """Match → list of (name, geom-id set)."""

    def scope_one(p: str) -> str:
      # Keep a leading anchor in front of the entity prefix: "^foot$" must
      # become "^robot/foot$", not "robot/^foot$".
      if p.startswith("^"):
        return f"^{re.escape(match.entity)}/{p[1:]}"
      return f"{re.escape(match.entity)}/{p}"

    def scoped(patterns):
      if match.entity is None:
        return patterns
      pats = patterns if isinstance(patterns, tuple) else (patterns,)
      return tuple(scope_one(p) for p in pats)

    exclude = tuple(scope_one(p) if match.entity else p for p in match.exclude)

    if match.mode == "geom":
      geom_names = [element_name(model, model.name_geomadr, i) for i in range(model.ngeom)]
      names = _match_names(scoped(match.pattern), geom_names, exclude)
      return [(n, {geom_names.index(n)}) for n in names]

    body_names = [element_name(model, model.name_bodyadr, i) for i in range(model.nbody)]
    items = []
    for n in _match_names(scoped(match.pattern), body_names, exclude):
      bid = body_names.index(n)
      if match.mode == "body":
        bids = [bid]
      else:  # subtree
        bids = [b for b in range(model.nbody)
                if _is_in_subtree(model.body_parentid, b, bid)]
      geoms = set()
      for b in bids:
        adr, num = int(model.body_geomadr[b]), int(model.body_geomnum[b])
        geoms.update(range(adr, adr + num))
      items.append((n, geoms))
    return items

  def initialize(self, model, ctx) -> None:
    super().initialize(model, ctx)
    tp = ctx.tp
    primaries = self._resolve_items(model, self.cfg.primary)
    if not primaries:
      raise ValueError(f"Contact sensor '{self.cfg.name}': no primary matches.")
    if self.cfg.secondary is not None:
      secondary_sets = self._resolve_items(model, self.cfg.secondary)
      secondary: set | None = set().union(*(s for _, s in secondary_sets))
    else:
      secondary = None

    # Each slot's geom sets, in slot order: the static pairs', then the
    # terrain groups' slots, whose geom1 is picked at run time from the
    # pool and so matches against the whole pool.
    slot_g1: list[frozenset] = []
    slot_g2: list[frozenset] = []
    for p in tp.pairs:
      slot_g1 += [frozenset((p.geom1,))] * p.ncon
      slot_g2 += [frozenset((p.geom2,))] * p.ncon
    for tg in tp.terrain_groups:
      pool = frozenset(int(g) for g in tg.pool_geoms)
      for g in tg.robot_geoms:
        slot_g1 += [pool] * tg.slots
        slot_g2 += [frozenset((int(g),))] * tg.slots

    self.item_names = [n for n, _ in primaries]
    per_item_slots, per_item_sign = [], []
    for _, pset in primaries:
      slots, signs = [], []
      for k, (g1, g2) in enumerate(zip(slot_g1, slot_g2)):
        p1, p2 = not g1.isdisjoint(pset), not g2.isdisjoint(pset)
        s1 = secondary is None or not g1.isdisjoint(secondary)
        s2 = secondary is None or not g2.isdisjoint(secondary)
        # The contact normal points geom1 → geom2: the force ON the primary
        # is +f when the primary is geom2 and −f when it is geom1. A slot is
        # listed once even when both geoms match (self-matching sensors).
        if p1 and s2:
          slots.append(k)
          signs.append(-1.0)
        elif p2 and s1:
          slots.append(k)
          signs.append(1.0)
      per_item_slots.append(slots)
      per_item_sign.append(signs)

    smax = max(1, max(len(s) for s in per_item_slots))
    N = len(per_item_slots)
    self._slot_idx = np.zeros((N, smax), dtype=np.int64)
    self._slot_valid = np.zeros((N, smax), dtype=bool)
    self._slot_sign = np.zeros((N, smax))
    for i, (slots, signs) in enumerate(zip(per_item_slots, per_item_sign)):
      self._slot_idx[i, : len(slots)] = slots
      self._slot_valid[i, : len(slots)] = True
      self._slot_sign[i, : len(slots)] = signs
    self.num_items = N
    dev = ctx.device
    self._idx = torch.as_tensor(self._slot_idx, device=dev)
    self._valid = torch.as_tensor(self._slot_valid, device=dev)
    self._sign = torch.as_tensor(self._slot_sign, dtype=ctx.dtype, device=dev)

  # -- state ----------------------------------------------------------------------

  def init_state(self) -> dict:
    if not self.cfg.track_air_time:
      return {}
    B, N = self._ctx.num_envs, self.num_items
    z = torch.zeros((B, N), dtype=self._ctx.dtype, device=self._ctx.device)
    return {
      "current_air_time": z,
      "last_air_time": z,
      "current_contact_time": z,
      "last_contact_time": z,
    }

  @property
  def state(self) -> dict:
    return self._ctx.ns("scene")["sensors"][self.cfg.name]

  # -- compute ----------------------------------------------------------------------

  def _gather(self) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, S) distances of the items' slots, and which are active."""
    c = self._ctx.data.contact
    dist = c.dist[:, self._idx]
    return dist, (dist < c.includemargin[:, self._idx]) & self._valid

  def _active(self) -> torch.Tensor:
    return self._gather()[1]

  @property
  def data(self) -> ContactData:
    cfg = self.cfg
    c = self._ctx.data.contact
    idx, sign = self._idx, self._sign
    dist, active = self._gather()
    out = ContactData()
    if "found" in cfg.fields:
      out.found = torch.sum(active, dim=-1).to(self._ctx.dtype)
    need_force = (
      "force" in cfg.fields or "torque" in cfg.fields
      or cfg.reduce in ("maxforce", "netforce")
    )
    if need_force:
      w_all = self._ctx.contact_forces()  # (B, C, 6) wrench, contact frame
      f_local = w_all[:, idx, :3] * active[..., None]  # (B, N, S, 3)
      t_local = w_all[:, idx, 3:] * active[..., None]
    frames = c.frame[:, idx]  # (B, N, S, 3, 3)
    pos = c.pos[:, idx]

    def pick(a, sel):  # a (B, N, S, ...) at the selected slot
      sel = sel.reshape(sel.shape + (1,) * (a.dim() - 2))
      return torch.take_along_dim(a, sel, dim=2)[:, :, 0]

    force = torque = None
    if cfg.reduce == "netforce":
      # World-frame net wrench on the primary, torque about the active-weighted
      # centroid of the contact points.
      f_world = torch.einsum("bnsi,bnsij->bnsj", f_local, frames) * sign[..., None]
      force = torch.sum(f_world, dim=2)
      if "torque" in cfg.fields:
        t_world = torch.einsum("bnsi,bnsij->bnsj", t_local, frames) * sign[..., None]
        wsum = torch.clamp_min(torch.sum(active, dim=-1, keepdim=True), 1)
        centroid = torch.sum(pos * active[..., None], dim=2) / wsum  # (B, N, 3)
        arm = pos - centroid[:, :, None]
        torque = torch.sum(t_world + mt.cross(arm, f_world), dim=2)
      inf = torch.full_like(dist, torch.inf)
      sel = torch.argmin(torch.where(active, dist, inf), dim=-1)
    else:
      if cfg.reduce == "maxforce":
        neg = torch.full_like(dist, -torch.inf)
        sel = torch.argmax(torch.where(active, torch.abs(f_local[..., 0]), neg), dim=-1)
      elif cfg.reduce == "mindist":
        inf = torch.full_like(dist, torch.inf)
        sel = torch.argmin(torch.where(self._valid, dist, inf), dim=-1)
      else:  # "none": the first active slot
        sel = torch.argmax(active.to(torch.int8), dim=-1)
      if need_force:
        force = pick(f_local, sel)
        if "torque" in cfg.fields:
          torque = pick(t_local, sel)
        if cfg.global_frame:
          # The selected wrench in the world frame, as the wrench ON the
          # primary (the sign flips where the primary is geom1).
          frame_s = pick(frames, sel)
          sgn_s = pick(sign.expand(dist.shape), sel)[..., None]
          force = torch.einsum("bni,bnij->bnj", force, frame_s) * sgn_s
          if torque is not None:
            torque = torch.einsum("bni,bnij->bnj", torque, frame_s) * sgn_s

    if "force" in cfg.fields:
      out.force = force
    if "torque" in cfg.fields:
      out.torque = torque
    if "dist" in cfg.fields:
      out.dist = pick(dist, sel)
    if "pos" in cfg.fields:
      out.pos = pick(pos, sel)
    if "normal" in cfg.fields or "tangent" in cfg.fields:
      frame_sel = pick(frames, sel)
      if "normal" in cfg.fields:
        out.normal = frame_sel[:, :, 0] * pick(sign.expand(dist.shape), sel)[..., None]
      if "tangent" in cfg.fields:
        out.tangent = frame_sel[:, :, 1]
    if cfg.track_air_time:
      st = self.state
      out.current_air_time = st["current_air_time"]
      out.last_air_time = st["last_air_time"]
      out.current_contact_time = st["current_contact_time"]
      out.last_contact_time = st["last_contact_time"]
    return out

  # -- air time state machine -----------------------------------------------------

  def update(self, dt: float) -> None:
    if not self.cfg.track_air_time:
      return
    in_contact = torch.any(self._active(), dim=-1)  # (B, N)
    st = self.state
    cat = st["current_air_time"]
    cct = st["current_contact_time"]
    first_contact = in_contact & (cat > 0)
    first_air = (~in_contact) & (cct > 0)
    st["last_air_time"] = torch.where(first_contact, cat + dt, st["last_air_time"])
    st["current_air_time"] = torch.where(in_contact, 0.0, cat + dt)
    st["last_contact_time"] = torch.where(first_air, cct + dt, st["last_contact_time"])
    st["current_contact_time"] = torch.where(in_contact, cct + dt, 0.0)

  def compute_first_contact(self, dt: float) -> torch.Tensor:
    """Envs whose item touched down within the last dt window."""
    st = self.state
    in_contact = torch.any(self._active(), dim=-1)
    return in_contact & (st["last_air_time"] > 0) & (
      st["current_contact_time"] <= dt + 1e-9
    )

  def compute_first_air(self, dt: float) -> torch.Tensor:
    st = self.state
    in_contact = torch.any(self._active(), dim=-1)
    return (~in_contact) & (st["last_contact_time"] > 0) & (
      st["current_air_time"] <= dt + 1e-9
    )

  def reset(self, env_mask=None) -> None:
    if not self.cfg.track_air_time:
      return
    st = self.state
    for k in list(st):
      if env_mask is None:
        st[k] = torch.zeros_like(st[k])
      else:
        st[k] = torch.where(env_mask[:, None], 0.0, st[k])
