"""Constraint assembly: Jacobians, impedances, reference accelerations (port
of mjlab_tpu/physics/constraint.py, joint-limit and pyramidal contact rows).

Rows are allocated statically: a row whose constraint is not included
(dist >= margin) gets D = 0 and is inert in the solver. Layout:
[joint limits | contact groups by condim], as in the JAX package (its
equality and dof-friction blocks are empty here: io.put_model refuses them).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.physics.types import (
  ConeType,
  Data,
  Model,
  Topology,
  float_tensor,
  index_tensor,
)

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """Constraint impedance d(r) from solimp = (dmin, dmax, width, mid, power)."""
  dmin, dmax, width, mid, power = solimp.unbind(-1)
  dmin = torch.clamp(dmin, _MINIMP, _MAXIMP)
  dmax = torch.clamp(dmax, _MINIMP, _MAXIMP)
  width = torch.clamp_min(width, _MINVAL)
  mid = torch.clamp(mid, _MINIMP, _MAXIMP)
  power = torch.clamp_min(power, 1.0)
  x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
  a = 1.0 / torch.pow(mid, power - 1)
  b = 1.0 / torch.pow(1 - mid, power - 1)
  y = torch.where(x < mid, a * torch.pow(x, power), 1 - b * torch.pow(1 - x, power))
  return torch.clamp(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def _kbi(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
  """Stiffness k, damping b and impedance from solver parameters."""
  imp = _impedance(solimp, pos)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  std = timeconst > 0
  b_std = 2.0 / torch.clamp_min(dmax * timeconst, _MINVAL)
  k_std = 1.0 / torch.clamp_min(
    dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL
  )
  b = torch.where(std, b_std, -solref[..., 1] / dmax)
  k = torch.where(std, k_std, -solref[..., 0] / (dmax * dmax))
  return k, b, imp


def _rows_from(J, pos, margin, solref, solimp, diag_approx, qvel, include):
  """Row finalization (D, aref) from the soft-constraint model; J is
  (B, R, nv), the rest broadcast to (B, R)."""
  k, b, imp = _kbi(solref, solimp, pos - margin)
  vel = (J @ qvel[..., None])[..., 0]
  aref = -b * vel - k * imp * (pos - margin)
  r = torch.clamp_min((1 - imp) / imp * diag_approx, _MINVAL)
  D = torch.where(include, 1.0 / r, torch.zeros_like(r))
  return D, aref


# ---------------------------------------------------------------------------
# Static slot tables.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlotTables:
  g1: np.ndarray
  g2: np.ndarray
  b1: np.ndarray
  b2: np.ndarray
  condim: np.ndarray
  slot_row_adr: np.ndarray
  slot_row_num: np.ndarray
  nrow_contact: int


def slot_tables(tp: Topology, cone: int) -> SlotTables:
  g1, g2, b1, b2, condim = [], [], [], [], []
  for p in tp.pairs:
    for _ in range(p.ncon):
      g1.append(p.geom1)
      g2.append(p.geom2)
      b1.append(int(tp.geom_bodyid[p.geom1]))
      b2.append(int(tp.geom_bodyid[p.geom2]))
      condim.append(p.condim)
  # The terrain groups' slots follow. Their terrain geom is picked at run
  # time but always welded to the world (b1 = 0); the pool's first geom
  # stands in for g1, and each robot geom keeps its own condim.
  for tg in tp.terrain_groups:
    for i, g in enumerate(tg.robot_geoms):
      for _ in range(tg.slots):
        g1.append(int(tg.pool_geoms[0]))
        g2.append(int(g))
        b1.append(0)
        b2.append(int(tp.geom_bodyid[g]))
        condim.append(int(tg.condim[i]))
  condim = np.asarray(condim, dtype=np.int32)
  adr = np.zeros(len(condim), dtype=np.int32)
  num = np.zeros(len(condim), dtype=np.int32)
  row = 0
  for c in sorted(set(condim.tolist())):
    for i in np.nonzero(condim == c)[0]:
      nrows = 1 if c == 1 else (2 * (c - 1) if cone == ConeType.PYRAMIDAL else c)
      adr[i] = row
      num[i] = nrows
      row += nrows
  return SlotTables(
    g1=np.asarray(g1), g2=np.asarray(g2), b1=np.asarray(b1), b2=np.asarray(b2),
    condim=condim, slot_row_adr=adr, slot_row_num=num, nrow_contact=row,
  )


def efc_row_types(tp: Topology) -> tuple[int, int, int, int]:
  """(ne, nf, nl, nc): equality, dof-friction, limit, contact row counts."""
  ne = tp.neq_rows
  nf = len(tp.friction_dof_ids)
  nl = len(tp.limited_joint_ids) + len(tp.limited_ball_joint_ids)
  return ne, nf, nl, tp.nefc - ne - nf - nl


def device_tables(tp: Topology, dtype, device) -> SimpleNamespace:
  def f(x):
    return float_tensor(x, dtype, device)

  def ix(x):
    return index_tensor(x, device)

  lj = tp.limited_joint_ids
  st = slot_tables(tp, ConeType.PYRAMIDAL)
  dmask = (tp.body_dof_mask[st.b2].astype(np.float64)
           - tp.body_dof_mask[st.b1].astype(np.float64))
  groups = [(cd, ix(np.nonzero(st.condim == cd)[0]))
            for cd in sorted(set(st.condim.tolist()))]
  # contact_forces: each condim group's slots and their efc rows.
  ne, nf, nl, _ = efc_row_types(tp)
  force_groups = []
  for cd in sorted(set(st.condim.tolist())):
    idx = np.nonzero(st.condim == cd)[0]
    nrows = 1 if cd == 1 else 2 * (cd - 1)
    rows = ne + nf + nl + st.slot_row_adr[idx][:, None] + np.arange(nrows)[None]
    force_groups.append((cd, ix(idx), ix(rows)))
  return SimpleNamespace(
    lim_jnt=ix(lj),
    lim_q=ix(tp.jnt_qposadr[lj]),
    lim_v=ix(tp.jnt_dofadr[lj]),
    lim_eye=f(np.eye(tp.nv)[tp.jnt_dofadr[lj]]),
    dof_origin_body=ix(tp.body_rootid[tp.dof_bodyid]),
    dmask=f(dmask),
    b1=ix(st.b1),
    b2=ix(st.b2),
    condim_groups=groups,
    force_groups=force_groups,
    ncon=len(st.condim),
  )


def contact_forces(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """Per-slot contact wrench in the contact frame, (B, C, 6): force
  [normal, t1, t2] then torque [torsion, roll1, roll2], zero beyond the
  contact's condim (port of the JAX package's constraint.contact_forces).
  Pyramidal decoding: normal = Σ λ_k, component_i = μ_i (λ_{i+} − λ_{i−})."""
  del m
  t = tp.dev.con
  B = d.efc_force.shape[0]
  out = d.efc_force.new_zeros((B, t.ncon, 6))
  for cd, idx, rows in t.force_groups:
    lam = d.efc_force[:, rows]  # (B, n, rows per slot)
    if cd == 1:
      comps = [lam[..., 0]]
    else:
      comps = [torch.sum(lam, dim=-1)]
      for f in range(1, cd):
        mu = d.contact.friction[:, idx, f - 1]
        comps.append(mu * (lam[..., 2 * (f - 1)] - lam[..., 2 * (f - 1) + 1]))
    comps += [torch.zeros_like(comps[0])] * (6 - len(comps))
    out[:, idx] = torch.stack(comps, dim=-1)
  return out


# ---------------------------------------------------------------------------
# Assembly.
# ---------------------------------------------------------------------------


def make_constraint(tp: Topology, m: Model, d: Data) -> Data:
  if tp.nefc == 0:
    return d
  t = tp.dev.con
  B, nv = d.qvel.shape
  parts = {k: [] for k in ("J", "D", "aref", "pos", "margin")}

  def add(J, D, aref, pos, margin):
    for k, v in (("J", J), ("D", D), ("aref", aref), ("pos", pos),
                 ("margin", margin)):
      parts[k].append(v)

  # 1) Joint limit rows (hinge/slide, nearest side).
  if t.lim_jnt.numel():
    lj = t.lim_jnt
    q = d.qpos[:, t.lim_q]
    dist_lo = q - m.jnt_range[lj, 0]
    dist_hi = m.jnt_range[lj, 1] - q
    lower = dist_lo < dist_hi
    dist = torch.where(lower, dist_lo, dist_hi)
    sign = torch.where(lower, 1.0, -1.0).to(dist.dtype)
    J = t.lim_eye * sign[..., None]
    margin = m.jnt_margin[lj].expand(B, -1)
    D, aref = _rows_from(
      J, dist, margin, m.jnt_solref[lj], m.jnt_solimp[lj],
      m.dof_invweight0[t.lim_v], d.qvel, include=dist < margin,
    )
    add(J, D, aref, dist, margin)

  # 2) Contact rows, vectorized over slots.
  if t.b1.numel():
    c = d.contact
    origins = d.subtree_com[:, t.dof_origin_body]  # (B, nv, 3)
    ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
    jac = lin[:, None] + mt.cross(
      ang[:, None], c.pos[:, :, None, :] - origins[:, None]
    )  # (B, C, nv, 3)
    jacp = jac * t.dmask[..., None]
    rows_nt = c.frame @ jacp.transpose(-1, -2)  # (B, C, 3, nv)
    invweight = m.body_invweight0[t.b1, 0] + m.body_invweight0[t.b2, 0]
    include = c.dist < c.includemargin

    for cd, idx in t.condim_groups:
      n_rows, inc, iw = rows_nt[:, idx, 0], include[:, idx], invweight[idx]
      pos_g = c.dist[:, idx]
      mar_g = c.includemargin[:, idx]
      ref_g, imp_g = c.solref[:, idx], c.solimp[:, idx]
      if cd == 1:
        D, aref = _rows_from(n_rows, pos_g, mar_g, ref_g, imp_g, iw, d.qvel, inc)
        add(n_rows, D, aref, pos_g, mar_g)
        continue
      # Pyramidal facets n ± mu_f·t_f; every facet's diagApprox uses the
      # sliding friction mu_1 (as MuJoCo, and the JAX package).
      nfacet = 2 * (cd - 1)
      mu0 = c.friction[:, idx, 0]
      dg = 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) * iw
      Js = []
      for f in range(1, cd):
        mu = c.friction[:, idx, f - 1, None]
        t_rows = rows_nt[:, idx, f]
        Js += [n_rows + mu * t_rows, n_rows - mu * t_rows]
      n = idx.shape[0]
      J = torch.stack(Js, dim=2).reshape(B, n * nfacet, nv)

      def rep(x):
        return torch.repeat_interleave(x, nfacet, dim=1)

      D, aref = _rows_from(
        J, rep(pos_g), rep(mar_g), rep(ref_g), rep(imp_g), rep(dg),
        d.qvel, rep(inc),
      )
      add(J, D, aref, rep(pos_g), rep(mar_g))

  D = torch.cat(parts["D"], dim=1)
  return d.replace(
    efc_J=torch.cat(parts["J"], dim=1),
    efc_D=D,
    efc_aref=torch.cat(parts["aref"], dim=1),
    efc_pos=torch.cat(parts["pos"], dim=1),
    efc_margin=torch.cat(parts["margin"], dim=1),
    efc_frictionloss=torch.zeros_like(D),
  )
