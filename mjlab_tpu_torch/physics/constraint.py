"""Constraint assembly: Jacobians, impedances, reference accelerations (port
of mjlab_tpu/physics/constraint.py).

Rows are allocated statically: a row whose constraint is not included
(dist >= margin) gets D = 0 and is inert in the solver. Layout, as in the
JAX package: [equality | dof friction | hinge and slide limits | ball
limits | tendon limits | contact groups by condim]. Equality rows are built per constraint (a few,
unrolled on the host); every other block is vectorized over its rows, and a
block a model does not have costs nothing. Contacts of condim 1/3/4/6 take
pyramidal facets or, under the elliptic cone, [normal | friction dims] rows.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mjlab_tpu_torch.core import math as mt
from mjlab_tpu_torch.kernels import chol, newton
from mjlab_tpu_torch.physics import smooth
from mjlab_tpu_torch.physics.types import (
  ConeType,
  Data,
  Model,
  Topology,
  float_tensor,
  index_tensor,
  mjtEq,
  mjtObj,
  per_env,
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


def _mv(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """(B, R, nv) @ (B, nv) → (B, R)."""
  return (J @ x[..., None])[..., 0]


def _rows_from(J, pos, margin, solref, solimp, diag_approx, qvel, include):
  """Row finalization (D, aref) from the soft-constraint model; J is
  (B, R, nv), the rest broadcast to (B, R)."""
  k, b, imp = _kbi(solref, solimp, pos - margin)
  aref = -b * _mv(J, qvel) - k * imp * (pos - margin)
  r = torch.clamp_min((1 - imp) / imp * diag_approx, _MINVAL)
  D = torch.where(include, 1.0 / r, torch.zeros_like(r))
  return D, aref


def _eq_rows_from(J, pos, solref, solimp, diag_approx, qvel, jdot_qdot):
  """Equality finalization: one impedance per constraint from the norm of
  its whole residual (B, rows), and the J̇q̇ bias in aref."""
  k, b, imp = _kbi(solref, solimp, torch.linalg.vector_norm(pos, dim=-1))
  aref = -b[..., None] * _mv(J, qvel) - (k * imp)[..., None] * pos - jdot_qdot
  r = torch.clamp_min(((1 - imp) / imp)[..., None] * diag_approx, _MINVAL)
  return 1.0 / r, aref


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
    g1=np.asarray(g1, dtype=np.int64), g2=np.asarray(g2, dtype=np.int64),
    b1=np.asarray(b1, dtype=np.int64), b2=np.asarray(b2, dtype=np.int64),
    condim=condim, slot_row_adr=adr, slot_row_num=num, nrow_contact=row,
  )


def efc_row_types(tp: Topology) -> tuple[int, int, int, int]:
  """(ne, nf, nl, nc): equality, dof-friction, limit (joint and tendon) and
  contact row counts, in efc layout order. The JAX package's counts the
  tendon-limit rows as contact rows, so its contact row addresses are off
  by their number on a model with both (ROADMAP Queue C); no model of its
  tests or tasks has both."""
  ne = tp.neq_rows
  nf = len(tp.friction_dof_ids)
  nl = (len(tp.limited_joint_ids) + len(tp.limited_ball_joint_ids)
        + len(tp.limited_tendon_ids))
  return ne, nf, nl, tp.nefc - ne - nf - nl


def contact_slot_row_adr(tp: Topology, cone: int) -> np.ndarray:
  """Absolute efc row address of each contact slot's first row."""
  ne, nf, nl, _ = efc_row_types(tp)
  return ne + nf + nl + slot_tables(tp, cone).slot_row_adr


def elliptic_cone_slots(tp: Topology) -> tuple[np.ndarray, np.ndarray]:
  """(slot indices, first-row addresses) of the condim ≥ 3 contacts under
  the elliptic cone: the slots the solver treats as cone constraints."""
  st = slot_tables(tp, ConeType.ELLIPTIC)
  idx = np.nonzero(st.condim >= 3)[0]
  return idx, contact_slot_row_adr(tp, ConeType.ELLIPTIC)[idx]


def _equality_tables(tp: Topology, f) -> list[SimpleNamespace]:
  """One static descriptor per active equality constraint, in row order."""
  out = []
  for e in np.nonzero(tp.eq_active0)[0]:
    et, o1, o2 = int(tp.eq_type[e]), int(tp.eq_obj1id[e]), int(tp.eq_obj2id[e])
    q = SimpleNamespace(e=int(e), type=et, o1=o1, o2=o2)
    if et in (mjtEq.mjEQ_CONNECT, mjtEq.mjEQ_WELD):
      q.site = int(tp.eq_objtype[e]) == mjtObj.mjOBJ_SITE
      q.b1 = int(tp.site_bodyid[o1]) if q.site else o1
      q.b2 = int(tp.site_bodyid[o2]) if q.site else o2
    elif et == mjtEq.mjEQ_JOINT:
      q.q1, q.v1 = int(tp.jnt_qposadr[o1]), int(tp.jnt_dofadr[o1])
      q.row1 = f(np.eye(tp.nv)[q.v1])
      if o2 >= 0:
        q.q2, q.v2 = int(tp.jnt_qposadr[o2]), int(tp.jnt_dofadr[o2])
        q.row2 = f(np.eye(tp.nv)[q.v2])
    out.append(q)
  return out


def device_tables(tp: Topology, dtype, device, cone: int = ConeType.PYRAMIDAL) -> SimpleNamespace:
  """The index, mask and layout tensors of assembly, contact_forces and the
  solver, for the model's cone."""
  def f(x):
    return float_tensor(x, dtype, device)

  def ix(x):
    return index_tensor(x, device)

  lj, fd, lt = tp.limited_joint_ids, tp.friction_dof_ids, tp.limited_tendon_ids
  bj = tp.limited_ball_joint_ids
  ball_dof = tp.jnt_dofadr[bj][:, None] + np.arange(3)[None]  # (nb, 3)
  st = slot_tables(tp, cone)
  dmask = (tp.body_dof_mask[st.b2].astype(np.float64)
           - tp.body_dof_mask[st.b1].astype(np.float64))
  condims = sorted(set(st.condim.tolist()))
  groups = [(cd, ix(np.nonzero(st.condim == cd)[0])) for cd in condims]
  ne, nf, _, _ = efc_row_types(tp)
  adr = contact_slot_row_adr(tp, cone)
  # contact_forces: each condim group's slots and their efc rows.
  force_groups = []
  for cd in condims:
    idx = np.nonzero(st.condim == cd)[0]
    rows = adr[idx][:, None] + np.arange(int(st.slot_row_num[idx[0]]))[None]
    force_groups.append((cd, ix(idx), ix(rows)))
  # The solver's cone groups (elliptic, condim ≥ 3), by condim, and the
  # per-slot layout the Newton kernel reads (first row, dim, offset of the
  # slot's dim x dim block in the packed cone Hessians).
  cone_groups, layout, boff = [], [], 0
  reg = np.ones(tp.nefc)
  if cone == ConeType.ELLIPTIC:
    cidx, cadr = elliptic_cone_slots(tp)
    for cd in sorted(set(st.condim[cidx].tolist())):
      sel = st.condim[cidx] == cd
      rows = cadr[sel][:, None] + np.arange(cd)[None]
      reg[rows.reshape(-1)] = 0.0
      cone_groups.append(SimpleNamespace(
        slots=ix(cidx[sel]), rows=ix(rows), flat_rows=ix(rows.reshape(-1)),
      ))
      for a in rows[:, 0]:
        layout.append((int(a), cd, boff))
        boff += cd * cd
  return SimpleNamespace(
    cone=cone,
    ne=ne, nf=nf,
    lim_jnt=ix(lj),
    lim_q=ix(tp.jnt_qposadr[lj]),
    lim_v=ix(tp.jnt_dofadr[lj]),
    lim_eye=f(np.eye(tp.nv)[tp.jnt_dofadr[lj]]),
    lim_ball=ix(bj),
    ball_q4=ix(tp.jnt_qposadr[bj][:, None] + np.arange(4)[None]),
    ball_v=ix(tp.jnt_dofadr[bj]),
    ball_eye=f(np.eye(tp.nv)[ball_dof]),  # (nb, 3, nv)
    fric_dof=ix(fd),
    fric_eye=f(np.eye(tp.nv)[fd]),
    ten_lim=ix(lt),
    ten_invweight=f(tp.tendon_invweight0[lt]),
    equality=_equality_tables(tp, f),
    dof_origin_body=ix(tp.body_rootid[tp.dof_bodyid]),
    dmask=f(dmask),
    b1=ix(st.b1),
    b2=ix(st.b2),
    condim_groups=groups,
    rot_rows=any(cd >= 4 for cd in condims),
    force_groups=force_groups,
    ncon=len(st.condim),
    # Solver: the row classes over [equality | friction | limits | contacts]
    # (is_eq, is_fric, reg and kind, each only where the model has such
    # rows) and the cone layout.
    **newton.row_classes(_row_kinds(tp.nefc, ne, nf, reg), dtype, device),
    cone_groups=cone_groups,
    cone_kernel_layout=chol.ConeLayout(
      table=torch.as_tensor(np.asarray(layout, dtype=np.int32).reshape(-1, 3), device=device),
      groups=tuple(_runs(layout)), nb=boff,
    ),
  )


def _row_kinds(nefc: int, ne: int, nf: int, reg: np.ndarray) -> np.ndarray:
  """Each row's class (kernels/newton.py): equality, friction loss, cone
  row (reg 0), else one-sided."""
  rows = np.arange(nefc)
  kind = np.where(rows < ne, newton.EQUALITY,
                  np.where(rows < ne + nf, newton.FRICTION, newton.ONE_SIDED))
  return np.where(reg == 0, newton.CONE_ROW, kind)


def _runs(layout: list[tuple[int, int, int]]):
  """(dim, first slot, slot count) of each run of one dim in the layout."""
  start = 0
  for i in range(1, len(layout) + 1):
    if i == len(layout) or layout[i][1] != layout[start][1]:
      yield layout[start][1], start, i - start
      start = i


def contact_forces(tp: Topology, m: Model, d: Data) -> torch.Tensor:
  """Per-slot contact wrench in the contact frame, (B, C, 6): force
  [normal, t1, t2] then torque [torsion, roll1, roll2], zero beyond the
  contact's condim (port of the JAX package's constraint.contact_forces).
  Pyramidal decoding: normal = Σ λ_k, component_i = μ_i (λ_{i+} − λ_{i−});
  elliptic rows are the components themselves."""
  del m
  t = tp.dev.con
  B = d.efc_force.shape[0]
  out = d.efc_force.new_zeros((B, t.ncon, 6))
  for cd, idx, rows in t.force_groups:
    lam = d.efc_force[:, rows]  # (B, n, rows per slot)
    if cd == 1:
      comps = [lam[..., 0]]
    elif t.cone == ConeType.ELLIPTIC:
      comps = list(lam.unbind(-1))
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


def _bmv3(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """(B, 3, 3) @ (3,) or (B, 3) → (B, 3)."""
  return (R @ v.expand(R.shape[:-2] + (3,))[..., None])[..., 0]


def _poly(coef: torch.Tensor, x: torch.Tensor):
  """Σ_k coef_k x^k and its derivative, for coef (5,) and x (B,)."""
  powers = torch.stack([torch.ones_like(x), x, x**2, x**3, x**4], dim=-1)
  dpowers = torch.stack(
    [torch.zeros_like(x), torch.ones_like(x), 2 * x, 3 * x**2, 4 * x**3], dim=-1
  )
  return powers @ coef, dpowers @ coef


def _vec_qmul(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """[0, w] ⊗ q for a (B, 3) vector w."""
  return mt.quat_mul(torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1), q)


def _weld(tp: Topology, m: Model, d: Data, q):
  """A weld's 6 rows (J, pos, J̇q̇, diagApprox). The rotation residual is
  −torquescale · vec(q_err), q_err = conj(q1·off1)·(q2·off2), whose rate
  along the motion is vec(½ [0, ω_loc] ⊗ q_err) with ω_loc the relative
  angular velocity in the q1·off1 frame. The JAX package takes its J̇q̇ (the
  second rate at q̈ = 0) by nested jvp through kinematics; here it is the
  closed form ½ ([0, ω̇_loc] ⊗ q_err + [0, ω_loc] ⊗ q̇_err), with
  ω̇_loc = R_refᵀ((α2 − α1) − ω1 × (ω2 − ω1)) and α the bodies' bias
  angular accelerations."""
  e, b1, b2 = q.e, q.b1, q.b2
  ts = m.eq_data[e, 10]
  if q.site:
    p1, p2 = d.site_xpos[:, q.o1], d.site_xpos[:, q.o2]
    site_quat = per_env(m.site_quat, 2)
    off1 = mt.normalize(site_quat[:, q.o1])
    off2 = mt.normalize(site_quat[:, q.o2])
  else:
    p2 = d.xpos[:, b2] + _bmv3(d.xmat[:, b2], m.eq_data[e, 0:3])
    p1 = d.xpos[:, b1] + _bmv3(d.xmat[:, b1], m.eq_data[e, 3:6])
    off1, off2 = mt.normalize(m.eq_data[e, 6:10]), None
  Jp = smooth.point_jac(tp, d, b1, p1) - smooth.point_jac(tp, d, b2, p2)
  q_ref = mt.quat_mul(d.xquat[:, b1], off1.expand(d.xquat[:, b1].shape))
  q_fol = d.xquat[:, b2] if off2 is None else mt.quat_mul(
    d.xquat[:, b2], off2.expand(d.xquat[:, b2].shape))
  q_err = mt.quat_mul(mt.quat_conjugate(q_ref), q_fol)
  t = tp.dev.smooth
  mask = t.body_dof[b2] - t.body_dof[b1]
  Jw = d.cdof[..., :3].transpose(-1, -2) * mask  # (B, 3, nv)
  R_ref = mt.quat_to_mat(q_ref)
  Jw_local = R_ref.transpose(-1, -2) @ Jw
  w_, x_, y_, z_ = q_err.unbind(-1)
  G = 0.5 * torch.stack(
    [torch.stack([w_, z_, -y_], -1), torch.stack([-z_, w_, x_], -1),
     torch.stack([y_, -x_, w_], -1)], dim=-2,
  )
  Jr = -ts * (G @ Jw_local)
  jd_p = (smooth.point_jdot_qdot(tp, d, b1, p1) - smooth.point_jdot_qdot(tp, d, b2, p2))
  w1, w2 = d.cvel[:, b1, :3], d.cvel[:, b2, :3]
  dw = w2 - w1
  acc = smooth.body_bias(tp, d, b2)[:, :3] - smooth.body_bias(tp, d, b1)[:, :3]
  Rt = R_ref.transpose(-1, -2)
  w_loc = _bmv3(Rt, dw)
  dw_loc = _bmv3(Rt, acc - mt.cross(w1, dw))
  qerr_dot = 0.5 * _vec_qmul(w_loc, q_err)
  jd_r = -ts * (0.5 * (_vec_qmul(dw_loc, q_err) + _vec_qmul(w_loc, qerr_dot)))[..., 1:]
  iw = torch.cat([
    (m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]).expand(3),
    (m.body_invweight0[b1, 1] + m.body_invweight0[b2, 1]).expand(3),
  ])
  return (torch.cat([Jp, Jr], dim=1), torch.cat([p1 - p2, -ts * q_err[..., 1:]], dim=-1),
          torch.cat([jd_p, jd_r], dim=-1), iw)


def _equality_rows(tp: Topology, m: Model, d: Data, add) -> None:
  """Connect (bodies or sites), weld (with torquescale), joint and tendon
  (polycoef) rows, each constraint's rows sharing one impedance."""
  B, dtype = d.qpos.shape[0], d.qpos.dtype
  for q in tp.dev.con.equality:
    e = q.e
    if q.type == mjtEq.mjEQ_CONNECT:
      if q.site:
        p1, p2 = d.site_xpos[:, q.o1], d.site_xpos[:, q.o2]
      else:
        p1 = d.xpos[:, q.b1] + _bmv3(d.xmat[:, q.b1], m.eq_data[e, 0:3])
        p2 = d.xpos[:, q.b2] + _bmv3(d.xmat[:, q.b2], m.eq_data[e, 3:6])
      J = smooth.point_jac(tp, d, q.b1, p1) - smooth.point_jac(tp, d, q.b2, p2)
      pos = p1 - p2
      jd = (smooth.point_jdot_qdot(tp, d, q.b1, p1)
            - smooth.point_jdot_qdot(tp, d, q.b2, p2))
      iw = (m.body_invweight0[q.b1, 0] + m.body_invweight0[q.b2, 0]).expand(3)
    elif q.type == mjtEq.mjEQ_JOINT:
      coef = m.eq_data[e, 0:5]
      pos = d.qpos[:, q.q1] - m.qpos0[..., q.q1]
      iw = m.dof_invweight0[q.v1]
      J = q.row1.expand(B, 1, -1)
      if q.o2 >= 0:
        poly, dpoly = _poly(coef, d.qpos[:, q.q2] - m.qpos0[..., q.q2])
        J = J - dpoly[:, None, None] * q.row2
        pos = pos - poly
        iw = iw + m.dof_invweight0[q.v2]
      else:
        pos = pos - coef[0]
      pos, iw = pos[:, None], iw.reshape(1)
      jd = torch.zeros_like(pos)  # no J̇q̇ for joint equalities (MuJoCo's)
    elif q.type == mjtEq.mjEQ_TENDON:
      coef = m.eq_data[e, 0:5]
      pos = d.ten_length[:, q.o1] - float(tp.tendon_length0[q.o1])
      J = d.ten_J[:, q.o1]
      iw_val = float(tp.tendon_invweight0[q.o1])
      if q.o2 >= 0:
        poly, dpoly = _poly(coef, d.ten_length[:, q.o2] - float(tp.tendon_length0[q.o2]))
        pos = pos - poly
        J = J - dpoly[:, None] * d.ten_J[:, q.o2]
        iw_val += float(tp.tendon_invweight0[q.o2])
      else:
        pos = pos - coef[0]
      pos, J = pos[:, None], J[:, None]
      jd = torch.zeros_like(pos)
      iw = torch.full((1,), iw_val, dtype=dtype, device=pos.device)
    else:  # mjEQ_WELD
      J, pos, jd, iw = _weld(tp, m, d, q)
    D, aref = _eq_rows_from(J, pos, m.eq_solref[e], m.eq_solimp[e], iw, d.qvel, jd)
    zeros = torch.zeros_like(pos)
    add(J, D, aref, pos, zeros, zeros)


def make_constraint(tp: Topology, m: Model, d: Data) -> Data:
  if tp.nefc == 0:
    return d
  t = tp.dev.con
  B = d.qvel.shape[0]
  parts = {k: [] for k in ("J", "D", "aref", "pos", "margin", "fl")}

  def add(J, D, aref, pos, margin, fl=None):
    for k, v in (("J", J), ("D", D), ("aref", aref), ("pos", pos),
                 ("margin", margin), ("fl", fl)):
      parts[k].append(v)

  # 0) Equality rows (bilateral, always included).
  if t.equality:
    _equality_rows(tp, m, d, add)

  # 1) Dof friction-loss rows: J a unit row, pos 0, always included.
  if t.fric_dof.numel():
    fd = t.fric_dof
    J = t.fric_eye.expand(B, -1, -1)
    zeros = d.qvel.new_zeros((B, fd.shape[0]))
    D, aref = _rows_from(J, zeros, zeros, m.dof_solref[fd], m.dof_solimp[fd],
                         m.dof_invweight0[fd], d.qvel, include=zeros == 0)
    add(J, D, aref, zeros, zeros, per_env(m.dof_frictionloss, 1)[:, fd].expand(B, -1))

  # 2) Joint limit rows (hinge/slide, nearest side).
  if t.lim_jnt.numel():
    lj = t.lim_jnt
    q = d.qpos[:, t.lim_q]
    jnt_range = per_env(m.jnt_range, 2)
    dist_lo = q - jnt_range[:, lj, 0]
    dist_hi = jnt_range[:, lj, 1] - q
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

  # 2b) Ball-joint limit rows, after the hinge and slide ones: one cone row
  # per limited ball, dist = range_max − ‖rotvec(q)‖ and J = −axis on the
  # ball's 3 dofs (its local angular velocity).
  if t.lim_ball.numel():
    bj = t.lim_ball
    q = d.qpos[:, t.ball_q4]  # (B, nb, 4)
    sin_half = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    axis = q[..., 1:] / torch.clamp_min(sin_half, _MINVAL)[..., None]
    dist = per_env(m.jnt_range, 2)[:, bj, 1] - angle
    J = -torch.sum(axis[..., None] * t.ball_eye, dim=-2)  # (B, nb, nv)
    margin = m.jnt_margin[bj].expand(B, -1)
    D, aref = _rows_from(
      J, dist, margin, m.jnt_solref[bj], m.jnt_solimp[bj],
      m.dof_invweight0[t.ball_v], d.qvel, include=dist < margin,
    )
    add(J, D, aref, dist, margin)

  # 2c) Tendon limit rows (nearest side), after the joint limits.
  if t.ten_lim.numel():
    lt = t.ten_lim
    L = d.ten_length[:, lt]
    dist_lo = L - m.tendon_range[lt, 0]
    dist_hi = m.tendon_range[lt, 1] - L
    lower = dist_lo < dist_hi
    dist = torch.where(lower, dist_lo, dist_hi)
    sign = torch.where(lower, 1.0, -1.0).to(dist.dtype)
    J = d.ten_J[:, lt] * sign[..., None]
    margin = m.tendon_margin[lt].expand(B, -1)
    D, aref = _rows_from(
      J, dist, margin, m.tendon_solref_lim[lt], m.tendon_solimp_lim[lt],
      t.ten_invweight, d.qvel, include=dist < margin,
    )
    add(J, D, aref, dist, margin)

  # 3) Contact rows, vectorized over slots.
  if t.b1.numel():
    _contact_rows(m, d, t, add)

  D = torch.cat(parts["D"], dim=1)
  fl = parts["fl"]
  return d.replace(
    efc_J=torch.cat(parts["J"], dim=1),
    efc_D=D,
    efc_aref=torch.cat(parts["aref"], dim=1),
    efc_pos=torch.cat(parts["pos"], dim=1),
    efc_margin=torch.cat(parts["margin"], dim=1),
    efc_frictionloss=(
      torch.cat([torch.zeros_like(x) if f is None else f for x, f in zip(parts["D"], fl)], dim=1)
      if t.fric_dof.numel() else torch.zeros_like(D)
    ),
  )


def _contact_rows(m: Model, d: Data, t, add) -> None:
  B, nv = d.qvel.shape
  c = d.contact
  origins = d.subtree_com[:, t.dof_origin_body]  # (B, nv, 3)
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  jac = lin[:, None] + mt.cross(
    ang[:, None], c.pos[:, :, None, :] - origins[:, None]
  )  # (B, C, nv, 3)
  jacp = jac * t.dmask[..., None]
  rows_nt = c.frame @ jacp.transpose(-1, -2)  # (B, C, 3, nv)
  # Torsional and rolling rows (condim 4/6): the contact-frame components
  # of the relative angular Jacobian.
  rows_rot = (
    c.frame @ (ang[:, None] * t.dmask[..., None]).transpose(-1, -2) if t.rot_rows else None
  )

  def axis_rows(idx, f):
    """Rows of friction axis f (1..5): tangents, then torsion and rolling."""
    return rows_nt[:, idx, f] if f < 3 else rows_rot[:, idx, f - 3]

  invweight = m.body_invweight0[t.b1, 0] + m.body_invweight0[t.b2, 0]
  include = c.dist < c.includemargin
  elliptic = t.cone == ConeType.ELLIPTIC

  for cd, idx in t.condim_groups:
    n_rows, inc, iw = rows_nt[:, idx, 0], include[:, idx], invweight[idx]
    pos_g = c.dist[:, idx]
    mar_g = c.includemargin[:, idx]
    ref_g, imp_g = c.solref[:, idx], c.solimp[:, idx]
    n = idx.shape[0]
    if cd == 1 or elliptic:
      D_n, aref_n = _rows_from(n_rows, pos_g, mar_g, ref_g, imp_g, iw, d.qvel, inc)
      if cd == 1:
        add(n_rows, D_n, aref_n, pos_g, mar_g)
        continue
      # Elliptic: [normal | friction dims] per contact. The friction rows
      # share the normal's D scaled by impratio·(μ_i/μ_1)² and have a
      # damping-only aref −b·vel, b from solreffriction where the contact
      # sets it, else from the normal's solref.
      mu0 = torch.clamp_min(c.friction[:, idx, 0], _MINVAL)
      sreff = c.solreffriction[:, idx]
      ref_fric = torch.where(torch.any(sreff != 0.0, dim=-1, keepdim=True), sreff, ref_g)
      _, b_g, _ = _kbi(ref_fric, imp_g, pos_g - mar_g)
      Js, Ds, arefs = [n_rows], [D_n], [aref_n]
      for f in range(1, cd):
        J_f = axis_rows(idx, f)
        ratio = c.friction[:, idx, f - 1] / mu0
        Js.append(J_f)
        Ds.append(D_n * m.opt.impratio * ratio * ratio)
        arefs.append(-b_g * _mv(J_f, d.qvel))
      rep = cd
      J = torch.stack(Js, dim=2).reshape(B, n * cd, nv)
      D = torch.stack(Ds, dim=2).reshape(B, n * cd)
      aref = torch.stack(arefs, dim=2).reshape(B, n * cd)
    else:
      # Pyramidal facets n ± mu_f·J_f; every facet's diagApprox uses the
      # sliding friction mu_1 (as MuJoCo, and the JAX package).
      rep = 2 * (cd - 1)
      mu0 = c.friction[:, idx, 0]
      dg = 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) * iw
      Js = []
      for f in range(1, cd):
        mu = c.friction[:, idx, f - 1, None]
        t_rows = axis_rows(idx, f)
        Js += [n_rows + mu * t_rows, n_rows - mu * t_rows]
      J = torch.stack(Js, dim=2).reshape(B, n * rep, nv)
      D, aref = _rows_from(
        J, *(torch.repeat_interleave(x, rep, dim=1)
             for x in (pos_g, mar_g, ref_g, imp_g, dg)),
        d.qvel, torch.repeat_interleave(inc, rep, dim=1),
      )
    add(J, D, aref, torch.repeat_interleave(pos_g, rep, dim=1),
        torch.repeat_interleave(mar_g, rep, dim=1))
