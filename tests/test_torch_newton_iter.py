"""The rest of the Newton iteration (kernels/newton.py): the warm start (the
choice between qacc_warmstart and a0 by cost, ending with the gradient at
the point it picks), the gradient, and the exact linesearch with the step's
acceptance (ending with the gradient, or the forces, at the point it
returns), their plain versions on the CPU and their kernels
(csrc/newton_iter.cu) on the card.

On the CPU (float64):
* the solver through the plain versions against the JAX package's
  `solver.solve` on the same forward state, within 1e-9 relative (1e-7
  where the two solutions' costs tie; see the test), on the small scenes
  of mjlab_tpu_torch/assets/solver_scenes.py (equality rows beside
  pyramidal contacts, friction-loss rows, CG) and three balls of condim 3,
  4 and 6 under the elliptic cone;
* one solve split into the entry points against the same solve written
  out whole (as the solver computed it before the split, every Newton
  iteration and linesearch step taken) bitwise, on those scenes and G1
  velocity-flat (port only); the solve's launch structure: one warm_start,
  one newton_linesearch per iteration, the last with the forces, and
  newton_gradient's forces only for a solve of 0 iterations (or one that
  stops early on the CPU);
* garbage in the J and aref rows of inactive rows (D = 0) changes no
  output, bitwise;
* a NaN direction leaves x unchanged where the step is accepted by its
  cost (NaN < c is false); the elliptic safeguard returns x + 0·p, NaN, as
  the JAX package's does.
On the card (`gpu`, skipped elsewhere): each kernel against its plain
version on seeded problems (a linesearch launch against
newton_linesearch_plain followed by newton_gradient_plain at the point it
returns), float64 within 1e-10 relative, float32 within max(1e-5 × scale,
4 × the plain float32 version's own error against float64) (where a
float32 acceptance or warm start decides a cost tie the other way, the two
chosen points' costs agree within 1e-5), NaN patterns equal, a step that
rounds to x not taken: active counts per world below, at and above the
kernels' CAP of rows in registers, row counts ragged at the edges of the
16-byte scan, every row inactive, a NaN direction, cone dims 3, 4 and 6 with
equality and friction-loss rows, nv 64, a grid of more worlds than the card
holds at once, and warm starts that win, lose, equal a0 or hold a NaN; the
gradient, w and blocks (and the forces) a linesearch or the warm start
returns at its point bitwise newton_gradient's there; w exactly 0 on every
unlisted row after the list's build and three iterations. tests/test_torch_newton_iter_emu.py runs the kernels'
source on the CPU in the warp emulator. This file imports JAX only inside
its CPU tests. On the card:
  python -m pytest --noconftest -m gpu tests/test_torch_newton_iter.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.kernels import chol, newton

PYR, ELL = 0, 1
LS_STEPS = 6
COST_TIE_TOL = 1e-7  # test_torch_elliptic.py's, for a cost tie


# ---------------------------------------------------------------------------
# Seeded problems.
# ---------------------------------------------------------------------------


# The warm starts `problem` makes: x itself, a point of lower cost than
# a0's, a0 exactly (a tie: a0 is kept), a point far from a0 (a0's cost is
# lower), x with a NaN (a0 is kept).
WARM_KINDS = ("x", "better", "a0", "far", "nan")


def _lower_cost_point(rows, x, p):
  """Per world, the point of least cost among a0 + s d (d = ±(x − a0) or
  ±p, s = 2⁻ᵏ, k < 30), a0 itself where none is lower."""
  a0 = rows.a0
  best, best_c = a0.clone(), rows.total_cost(a0)
  for d in (x - a0, a0 - x, p, -p):
    for k in range(30):
      y = a0 + 2.0**-k * d
      c = rows.total_cost(y)
      take = c < best_c
      best = torch.where(take[:, None], y, best)
      best_c = torch.where(take, c, best_c)
  return best


def problem(seed, batch, n, m_reg, ne=0, nf=0, cds=(), active=0.3, counts=None,
            dtype=torch.float64, device="cpu", garbage=False, zero=False, warm="mixed"):
  """(Rows, x, p, ws): M = X Xᵀ/n + 0.5 I, J, a0, aref normal, D uniform on
  the active rows (a share `active`, or `counts` per world) and 0
  elsewhere; the first `ne` rows equality rows, the next `nf` friction-loss
  rows, then one cone slot of each dim in `cds` after the regular rows,
  active in about 70% of the worlds. With `garbage`, the inactive rows' J
  and aref are replaced by large seeded values; with `zero`, every row is
  inactive. ws is a warm start of the kind `warm` (WARM_KINDS) in every
  world, or with "mixed" world i's of kind WARM_KINDS[i % 5], made in
  float64."""
  rng = np.random.default_rng(seed)
  m = m_reg + sum(cds)
  X = rng.normal(size=(batch, n, n))
  M = X @ np.swapaxes(X, -1, -2) / n + 0.5 * np.eye(n)
  J = rng.normal(size=(batch, m, n)) / np.sqrt(n)
  a0 = rng.normal(size=(batch, n))
  aref = rng.normal(size=(batch, m))
  D = rng.uniform(0.5, 5.0, size=(batch, m))
  if counts is None:
    keep = rng.uniform(size=(batch, m_reg)) < active
  else:
    keep = np.zeros((batch, m_reg), dtype=bool)
    for w in range(batch):
      keep[w, rng.choice(m_reg, size=counts[w % len(counts)], replace=False)] = True
  D[:, :m_reg] = np.where(keep, D[:, :m_reg], 0.0)
  kind = np.zeros(m, dtype=np.int32)
  kind[:ne] = newton.EQUALITY
  kind[ne : ne + nf] = newton.FRICTION
  table, off, r = [], 0, m_reg
  for cd in cds:
    kind[r : r + cd] = newton.CONE_ROW
    table.append((r, cd, off))
    D[rng.uniform(size=batch) >= 0.7, r : r + cd] = 0.0
    off += cd * cd
    r += cd
  if zero:
    D[:] = 0.0
  if garbage:
    g = np.random.default_rng(seed + 1000)
    J = np.where((D == 0)[..., None], 1e3 * g.normal(size=J.shape), J)
    aref = np.where(D == 0, 1e3 * g.normal(size=aref.shape), aref)
  fl = rng.uniform(0.1, 1.0, size=(batch, m))
  mu0 = rng.uniform(0.3, 1.2, size=(batch, max(len(cds), 1)))
  x = a0 + 0.3 * rng.normal(size=(batch, n))
  p = rng.normal(size=(batch, n))

  def rows_of(dtype, device):
    def t(a):
      return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    layout = None
    if cds:
      groups, start = [], 0
      for i in range(1, len(table) + 1):
        if i == len(table) or table[i][1] != table[start][1]:
          groups.append((table[start][1], start, i - start))
          start = i
      layout = chol.ConeLayout(table=torch.tensor(table, dtype=torch.int32, device=device),
                               groups=tuple(groups), nb=off)
    return newton.Rows(t(M), t(J), t(D), t(aref), t(a0), fl=t(fl) if nf else None,
                       **newton.row_classes(kind, dtype, device), layout=layout,
                       mu0=t(mu0) if cds else None), t

  kinds = [WARM_KINDS[w % len(WARM_KINDS)] if warm == "mixed" else warm for w in range(batch)]
  gw = np.random.default_rng(seed + 2000)
  ws = x.copy()
  if "better" in kinds:
    rows64, t64 = rows_of(torch.float64, "cpu")
    better = _lower_cost_point(rows64, t64(x), t64(p)).numpy()
  for w, k in enumerate(kinds):
    if k == "better":
      ws[w] = better[w]
    elif k == "a0":
      ws[w] = a0[w]
    elif k == "far":
      ws[w] = a0[w] + 100.0 * gw.normal(size=n)
    elif k == "nan":
      ws[w, gw.integers(n)] = np.nan
  rows, t = rows_of(dtype, device)
  return rows, t(x), t(p), t(ws)


def same(a, b) -> bool:
  """torch.equal, with a NaN equal to a NaN."""
  if not a.is_floating_point():
    return torch.equal(a, b)
  nan = torch.isnan(a)
  return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def linesearch_plain(rows, x, p, iterations, safeguard, forces=False):
  """One linesearch launch by the plain versions: newton_linesearch_plain,
  then newton_gradient_plain at the point it returns."""
  xo, alpha, improved = newton.newton_linesearch_plain(rows, x, p, iterations, safeguard)
  return xo, alpha, improved, newton.newton_gradient_plain(rows, xo, forces)


# The outputs that depend on the linesearch's acceptance (suffixed 0, or 1
# with the safeguard).
AT_POINT = ("x", "xf", "grad_ls", "w_ls", "blocks_ls", "force_ls", "qfrc_ls")


# The warm start's outputs that depend on its choice ("improved_ws": ws
# taken).
WS_AT_POINT = ("ws_x0", "ws_grad", "ws_w", "ws_blocks")


def outputs(rows, x, p, ws, fn):
  """Every entry point's outputs on (rows, x, p, ws), by `fn`'s versions:
  the gradient and the forces at x, each linesearch (with and without the
  safeguard where the rows have cone slots) with the gradient and with the
  forces at the point it returns, and the warm start from ws (its point,
  both costs, the gradient, w and blocks there, and whether it took ws).
  The solve's buffers that the kernels return (w, the blocks) are copied as
  they come."""

  def keep(t):
    return None if t is None else t.clone()

  grad, w, blocks = fn["gradient"](rows, x)
  out = {"grad": grad, "w": keep(w)}
  if blocks is not None:
    out["blocks"] = keep(blocks)
  force, qfrc = fn["gradient"](rows, x, forces=True)
  out.update(force=force, qfrc=qfrc)
  for sg in (False, True) if rows.layout is not None else (False,):
    s = int(sg)
    xo, alpha, improved, (g, w, b) = fn["linesearch"](rows, x, p, LS_STEPS, sg)
    out.update({f"x{s}": xo, f"alpha{s}": alpha, f"improved{s}": improved, f"grad_ls{s}": g,
                f"w_ls{s}": keep(w)})
    if b is not None:
      out[f"blocks_ls{s}"] = keep(b)
    xf, _, _, (f, q) = fn["linesearch"](rows, x, p, LS_STEPS, sg, forces=True)
    out.update({f"xf{s}": xf, f"force_ls{s}": f, f"qfrc_ls{s}": q})
  x0, cost, g, w, b = fn["warm_start"](rows, ws)
  out.update(ws_x0=x0, ws_cost=cost, ws_grad=g, ws_w=keep(w),
             improved_ws=cost[:, 0] < cost[:, 1])
  if b is not None:
    out["ws_blocks"] = keep(b)
  return out


PLAIN = {"gradient": newton.newton_gradient_plain, "linesearch": linesearch_plain,
         "warm_start": newton.warm_start_plain}
WRAPPED = {"gradient": newton.newton_gradient, "linesearch": newton.newton_linesearch,
           "warm_start": newton.warm_start}


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package, and their semantics.
# ---------------------------------------------------------------------------


# Three balls spinning and sliding on a floor under the elliptic cone, one
# contact each of condim 3, 4 and 6: every cone dim in one scene (the
# spinner scenes' ball, friction and velocity).
CONE_DIMS_XML = """
<mujoco model="cone_dims">
  <option timestep="0.002" cone="elliptic"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" friction="0.6 0.08 0.01"/>
""" + "".join(f"""
    <body pos="{i} 0 0.0999">
      <freejoint/>
      <geom type="sphere" size="0.1" density="700" friction="0.6 0.08 0.01" condim="{cd}"/>
    </body>""" for i, cd in enumerate((3, 4, 6))) + """
  </worldbody>
</mujoco>
"""


def _scene_state(name, cone, worlds=4, seed=0):
  """The port's and JAX's models of a solver scene (or of CONE_DIMS_XML for
  "cone_dims", under spinner_condim6's options) and the port's forward
  state just before the solve, from the scene's velocity with seeded noise
  and a seeded warm start."""
  import tests.torch_parity as tp
  from mjlab_tpu_torch import physics as tphysics
  from mjlab_tpu_torch.assets.solver_scenes import SCENES
  from mjlab_tpu_torch.physics import io as tio
  from mjlab_tpu_torch.physics import smooth as tsmooth
  from mjlab_tpu_torch.physics.forward import fwd_position, fwd_velocity

  dims = name == "cone_dims"
  mj = tp.solver_scene_model("spinner_condim6" if dims else name, cone,
                             CONE_DIMS_XML if dims else None)
  ttp, tm = tio.put_model(mj, dtype=torch.float64, device="cpu")
  rng = np.random.default_rng(seed)
  d = tphysics.make_data(ttp, tm, worlds)
  qv = np.zeros(d.qvel.shape)
  v0 = SCENES["spinner_condim6" if dims else name].qvel
  for b in range(3 if dims else 1):
    qv[:, 6 * b : 6 * b + len(v0)] = v0
  d = d.replace(qvel=torch.tensor(qv + 0.2 * rng.normal(size=qv.shape)))
  if name == "cg_box":  # from 4 cm above the floor to its face
    d = d.replace(qpos=d.qpos - 0.037 * (torch.arange(d.qpos.shape[1]) == 2))
  for _ in range(300):  # into contact: at least 3 substeps, then until a row is active
    d = tphysics.step(ttp, tm, d)
    if int(d.time[0] / mj.opt.timestep) >= 3 and (d.efc_D != 0).any():
      break
  d = fwd_velocity(ttp, tm, fwd_position(ttp, tm, d))
  d = tsmooth.fwd_acceleration(ttp, tm, tsmooth.fwd_actuation(ttp, tm, d))
  d = d.replace(qacc_warmstart=d.qacc_warmstart
                + torch.tensor(rng.normal(size=d.qacc.shape)))
  return mj, ttp, tm, d


# connect_with_contact: equality rows beside pyramidal contact rows (the
# one-sided class); frictionloss: Huber rows; cone_dims: the elliptic cone
# at condim 3, 4 and 6 in one scene; CG.
JAX_CASES = [("connect_with_contact", None), ("frictionloss", None), ("cone_dims", None),
             ("cg_box", None)]
SCENE_CASES = [("spinner_condim4", PYR), ("puck", None), *JAX_CASES]


@pytest.mark.parametrize("name, cone", JAX_CASES)
def test_plain_solve_matches_jax(name, cone):
  import jax
  import jax.numpy as jnp

  import tests.torch_parity as tp
  from mjlab_tpu import physics as jphysics
  from mjlab_tpu.physics import solver as jsolver
  from mjlab_tpu_torch.physics import io as tio
  from mjlab_tpu_torch.physics import solver as tsolver

  with tp.torch_threads(1):
    mj, ttp, tm, d = _scene_state(name, cone)
    got = tio.data_to_arrays(tsolver.solve(ttp, tm, d))
  jtp, jm = jphysics.put_model(mj, dtype=jnp.float64)
  jd = jax.jit(jax.vmap(lambda dd: jsolver.solve(jtp, jm, dd)))(
    tp.jax_data_from_arrays(tio.data_to_arrays(d)))
  want = tp.jax_data_arrays(jd)
  assert np.abs(want["efc_force"]).max() > 0, "no constraint force"
  # The step's acceptance keeps x where no step lowers its cost in rounding,
  # so two solves whose sums round differently may stop at two points whose
  # costs tie (world 1 of connect_with_contact: qacc 1.4e-9 apart relative
  # to its scale). Where they differ by more than 1e-9, the costs at both
  # solutions must agree within 1e-14 and the solutions within COST_TIE_TOL.
  rel = {f: np.abs(got[f] - want[f]).max(-1) / max(1.0, np.abs(want[f]).max())
         for f in ("qacc", "efc_force", "qfrc_constraint")}
  tied = np.zeros(len(rel["qacc"]), dtype=bool)
  for f, err in rel.items():
    tied |= err > 1e-9
  if tied.any():
    from mjlab_tpu_torch.kernels import newton as tnewton

    rows = tnewton.Rows.of(ttp, d)
    c_port = rows.total_cost(torch.tensor(got["qacc"])).numpy()
    c_jax = rows.total_cost(torch.tensor(want["qacc"])).numpy()
    assert np.all(np.abs(c_port - c_jax)[tied] <= 1e-14 * np.abs(c_jax)[tied]), (name, tied)
  for f in rel:
    tp.assert_close(got[f][~tied], want[f][~tied], 1e-9, f"{name}: {f}")
    tp.assert_close(got[f], want[f], COST_TIE_TOL, f"{name}: {f} at a cost tie")


def _bdot(a, b):
  return torch.sum(a * b, dim=-1)


def _mv(M, x):
  return (M @ x[..., None])[..., 0]


def _all_steps(rows, x, r, p, iterations):
  """Rows.linesearch with every step taken (no stop at a fixed point)."""
  jv = _mv(rows.J, p)
  p_m_dx = _bdot(p, _mv(rows.qM, x - rows.a0))
  p_m_p = _bdot(p, _mv(rows.qM, p))
  cones = [rows.cone_line(g, r[:, g.rows], jv[:, g.rows]) for g in rows.groups]
  alpha = torch.ones_like(p_m_p)
  for _ in range(iterations):
    ra = r + alpha[:, None] * jv
    dphi = p_m_dx + alpha * p_m_p - _bdot(rows.regular_force(ra), jv)
    ddphi = p_m_p + _bdot(rows.row_hess(ra), jv * jv)
    for line in cones:
      slope, curv = line(alpha)
      dphi = dphi - torch.sum(slope, dim=-1)
      ddphi = ddphi + torch.sum(curv, dim=-1)
    alpha = alpha - dphi / torch.clamp_min(ddphi, 1e-30)
  return alpha


def _whole_solve(tp_, m, d):
  """The solve written out whole, as the solver computed it before it was
  split into the three entry points: every Newton iteration and
  linesearch step taken."""
  rows = newton.Rows.of(tp_, d)
  a0, ws, Jt = rows.a0, d.qacc_warmstart, rows.J.transpose(-1, -2)
  x = torch.where((rows.total_cost(ws) < rows.total_cost(a0))[:, None], ws, a0)

  def grad_at(x):
    return _mv(rows.qM, x - a0) - _mv(Jt, rows.row_force(rows.residual(x)))

  if m.opt.solver == 1:  # CG
    qM = rows.qM
    Lm = chol.chol_factor(qM + 1e-12 * torch.eye(qM.shape[-1], dtype=qM.dtype))
    g_prev = grad_at(x)
    mg_prev = chol.chol_solve(Lm, g_prev)
    p = -mg_prev
    for _ in range(m.opt.iterations):
      alpha = _all_steps(rows, x, rows.residual(x), p, m.opt.ls_iterations)
      x_new = x + alpha[:, None] * p
      improve = rows.total_cost(x_new) < rows.total_cost(x)
      x = torch.where(improve[:, None], x_new, x)
      g = grad_at(x)
      mg = chol.chol_solve(Lm, g)
      beta = torch.clamp_min(_bdot(g, mg - mg_prev) / torch.clamp_min(_bdot(g_prev, mg_prev),
                                                                      1e-15), 0.0)
      p = -mg + torch.where(improve, beta, torch.zeros_like(beta))[:, None] * p
      g_prev, mg_prev = g, mg
  else:
    for _ in range(m.opt.iterations):
      r = rows.residual(x)
      grad = _mv(rows.qM, x - a0) - _mv(Jt, rows.row_force(r))
      w = rows.row_hess(r)
      if rows.groups:
        p = -chol.newton_direction_cone(rows.qM, rows.J, w, grad, rows.cone_blocks(r),
                                        rows.layout)
      else:
        p = -chol.newton_direction(rows.qM, rows.J, w, grad)
      alpha = _all_steps(rows, x, r, p, m.opt.ls_iterations)
      if rows.groups:
        best_cost, best_alpha = rows.total_cost(x), torch.zeros_like(alpha)
        for cand in (alpha, 1.0, 0.5, 0.25, 0.1, 0.01):
          ca = cand if torch.is_tensor(cand) else torch.full_like(alpha, cand)
          c = rows.total_cost(x + ca[:, None] * p)
          better = c < best_cost
          best_cost = torch.where(better, c, best_cost)
          best_alpha = torch.where(better, ca, best_alpha)
        x = x + best_alpha[:, None] * p
      else:
        x_new = x + alpha[:, None] * p
        x = torch.where((rows.total_cost(x_new) < rows.total_cost(x))[:, None], x_new, x)
  f = rows.row_force(rows.residual(x))
  return x, f, _mv(Jt, f)


def _g1_state(cone):
  """The port's G1 velocity-flat forward state (f64, 2 worlds, the
  committed scene) just before a solve, after 3 substeps from seeded
  joint offsets."""
  from mjlab_tpu_torch import physics as tphysics
  from mjlab_tpu_torch.assets import g1_velocity_sim_cfg, load_model_npz
  from mjlab_tpu_torch.physics import smooth as tsmooth
  from mjlab_tpu_torch.physics.forward import fwd_position, fwd_velocity
  from mjlab_tpu_torch.sim import Simulation

  cfg = g1_velocity_sim_cfg()
  cfg.dtype = "float64"
  cfg.mujoco.cone = cone
  model = load_model_npz()
  sim = Simulation(2, cfg, model, device="cpu")
  q = torch.tensor(model.key_qpos[0], dtype=torch.float64).expand(2, -1).clone()
  q[:, 7:] += 0.05 * torch.randn(2, model.nq - 7, generator=torch.Generator().manual_seed(1),
                                 dtype=torch.float64)
  q[:, 2] -= 0.02
  d = sim.make_data().replace(qpos=q)
  for _ in range(3):
    d = tphysics.step(sim.tp, sim.model, d)
  d = fwd_velocity(sim.tp, sim.model, fwd_position(sim.tp, sim.model, d))
  d = tsmooth.fwd_acceleration(sim.tp, sim.model, tsmooth.fwd_actuation(sim.tp, sim.model, d))
  return sim.tp, sim.model, d


@pytest.mark.parametrize("case", [*SCENE_CASES, ("g1", "pyramidal")],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_split_solve_equals_the_whole_bitwise(case):
  import tests.torch_parity as tp
  from mjlab_tpu_torch.physics import solver as tsolver

  name, cone = case
  with tp.torch_threads(1):
    if name == "g1":
      tp_, m, d = _g1_state(cone)
    else:
      _, tp_, m, d = _scene_state(name, cone, worlds=2)
    got = tsolver.solve(tp_, m, d)
    x, f, qfrc = _whole_solve(tp_, m, d)
  for what, a, b in (("qacc", got.qacc, x), ("efc_force", got.efc_force, f),
                     ("qfrc_constraint", got.qfrc_constraint, qfrc)):
    assert newton.same_bits(a, b), f"{name} {cone}: {what}"


@pytest.mark.parametrize("cds", [(), (3, 4, 6)])
def test_inactive_rows_garbage_changes_nothing_bitwise(cds):
  """Finite garbage in the J and aref rows of every row with D = 0 leaves
  every plain output bitwise as it was."""
  clean = problem(3, 5, 9, 40, ne=2, nf=3, cds=cds)
  dirty = problem(3, 5, 9, 40, ne=2, nf=3, cds=cds, garbage=True)
  assert not torch.equal(clean[0].J, dirty[0].J)
  a, b = outputs(*clean, PLAIN), outputs(*dirty, PLAIN)
  for k in a:
    assert same(a[k], b[k]), k


@pytest.mark.parametrize("cds", [(), (3, 4)])
def test_nan_direction(cds):
  """A NaN direction in world 1: the cost test keeps x there (NaN < c is
  false) and the other worlds step as they would alone; the elliptic
  safeguard keeps no candidate and returns x + 0·p, NaN, as the JAX
  package's does."""
  rows, x, p, _ = problem(4, 3, 8, 30, ne=1, nf=2, cds=cds)
  p_nan = p.clone()
  p_nan[1, 2] = float("nan")
  xo, _, improved = newton.newton_linesearch_plain(rows, x, p_nan, LS_STEPS, False)
  ref, _, ref_improved = newton.newton_linesearch_plain(rows, x, p, LS_STEPS, False)
  assert torch.equal(xo[1], x[1]) and not improved[1]
  assert torch.equal(xo[[0, 2]], ref[[0, 2]]) and torch.equal(improved[[0, 2]],
                                                              ref_improved[[0, 2]])
  if cds:
    xs, _, improved = newton.newton_linesearch_plain(rows, x, p_nan, LS_STEPS, True)
    assert torch.isnan(xs[1, 2]) and not improved[1]
    assert torch.equal(xs[1, :2], x[1, :2])


def test_wrappers_take_the_plain_path_on_the_cpu():
  prob = problem(5, 5, 7, 20, ne=1, nf=1, cds=(3,))
  newton.reset_counts()
  a, b = outputs(*prob, WRAPPED), outputs(*prob, PLAIN)
  assert all(same(a[k], b[k]) for k in a)
  assert all(v == 0 for v in newton.LAUNCHES.values())
  assert prob[0]._card is None  # no buffer of the card's
  assert newton.scratch_elems(newton.CAP) == 0
  assert newton.scratch_elems(1699) == newton.FIELDS * (1699 - newton.CAP)
  assert newton.scratch_elems(1320, 1137) == (newton.FIELDS * (1320 - newton.CAP)
                                              + newton.CONE_FIELDS * (1137 - newton.CONE_CAP))


@pytest.mark.parametrize("iterations", [4, 0])
@pytest.mark.parametrize("name, cone", [("connect_with_contact", None), ("cg_box", None),
                                        ("cone_dims", None)])
def test_solve_launch_structure(name, cone, iterations, monkeypatch):
  """A solve calls warm_start once, first, and newton_linesearch once per
  iteration, the last one with the forces; newton_gradient only for the
  forces: after the warm start in a solve of 0 iterations, or on the CPU
  where a solve stops early at a fixed point."""
  import tests.torch_parity as tp
  from mjlab_tpu_torch.physics import solver as tsolver

  calls = []

  def counted(name, fn):
    def call(*args, **kw):
      calls.append((name, bool(kw.get("forces", False))))
      return fn(*args, **kw)
    return call

  for f in ("warm_start", "newton_gradient", "newton_linesearch"):
    monkeypatch.setattr(newton, f, counted(f, getattr(newton, f)))
  with tp.torch_threads(1):
    _, tp_, m, d = _scene_state(name, cone, worlds=2)
    m.opt.iterations = iterations
    calls.clear()
    tsolver.solve(tp_, m, d)
  ls = [f for n, f in calls if n == "newton_linesearch"]
  gradients = [f for n, f in calls if n == "newton_gradient"]
  assert calls[0] == ("warm_start", False) and sum(n == "warm_start" for n, _ in calls) == 1
  if iterations == 0:
    assert calls == [("warm_start", False), ("newton_gradient", True)]
  elif len(ls) == iterations and ls[-1]:
    assert not any(ls[:-1]) and not gradients
  else:
    assert 1 <= len(ls) < iterations and not any(ls)
    assert gradients == [True] and calls[-1] == ("newton_gradient", True)


def test_row_classes_follow_the_constraint_tables():
  """The kernels' int32 classes agree with the masks the plain version
  reads: equality, friction loss, cone rows, one-sided otherwise."""
  import tests.torch_parity as tp
  from mjlab_tpu_torch.physics import io as tio

  for name, cone, want in (("spinner_condim4", PYR, None), ("connect_with_contact", None, 1),
                           ("frictionloss", None, 2), ("spinner_condim6", ELL, 3)):
    ttp, _ = tio.put_model(tp.solver_scene_model(name, cone), dtype=torch.float64,
                           device="cpu")
    t = ttp.dev.con
    if want is None:
      assert t.kind is None
      continue
    kind = t.kind.numpy()
    assert (kind == want).any()
    for mask, k in ((t.is_eq, newton.EQUALITY), (t.is_fric, newton.FRICTION)):
      if mask is not None:
        assert np.array_equal(mask.numpy() > 0, kind == k)
    if t.reg is not None:
      assert np.array_equal(t.reg.numpy() == 0, kind == newton.CONE_ROW)


# ---------------------------------------------------------------------------
# The card: each kernel against its plain version.
# ---------------------------------------------------------------------------


def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _check_on_card(args, dtype):
  """Every kernel against its plain version on the problem `args` of
  `problem`: float64 within 1e-10 relative, float32 within max(1e-5 ×
  scale, 4 × the plain float32 version's error against float64). In float32
  the step's acceptance or the warm start may decide a cost tie the other
  way (two sums over the rows rounded differently): where it does, the two
  chosen points' costs (in float64) agree within 1e-5 relative, and the
  outputs at the chosen point are compared elsewhere."""
  prob = problem(*args[0], **args[1], dtype=dtype, device="cuda")
  rows = prob[0]
  newton.reset_counts()
  got = outputs(*prob, WRAPPED)
  torch.cuda.synchronize()
  ls = 2 if rows.layout is not None else 1
  assert newton.LAUNCHES == {"warm_start": 1, "newton_gradient": 2, "newton_linesearch": 2 * ls}
  plain = outputs(*prob, PLAIN)
  rows64, *_ = problem(*args[0], **args[1], dtype=torch.float64, device="cuda")
  ref = outputs(*problem(*args[0], **args[1], dtype=torch.float64, device="cuda"), PLAIN)
  # Each acceptance: the point it picks and the outputs that depend on it.
  accepted = {f"improved{sg}": (f"x{sg}", [f"{k}{sg}" for k in AT_POINT]) for sg in range(ls)}
  accepted["improved_ws"] = ("ws_x0", WS_AT_POINT)
  keep = {}
  for acc, (point, dependents) in accepted.items():
    flips = got[acc] != plain[acc]
    if flips.any():
      assert dtype == torch.float32, f"{acc}: {int(flips.sum())} worlds"
      c_got = rows64.total_cost(got[point].double())[flips]
      c_plain = rows64.total_cost(plain[point].double())[flips]
      assert ((c_got - c_plain).abs() <= 1e-5 * c_plain.abs().clamp_min(1.0)).all(), acc
    for k in dependents:
      keep[k] = ~flips
  for k, g in got.items():
    if k.startswith("improved"):
      continue
    want, p32 = ref[k], plain[k]
    if k in keep:
      g, want, p32 = g[keep[k]], want[keep[k]], p32[keep[k]]
    assert torch.equal(torch.isnan(g), torch.isnan(p32)), f"{k}: NaN pattern"
    ok = ~torch.isnan(p32)
    if not ok.any():
      continue
    err = (g.double() - want)[ok].abs().max().item()
    scale = max(1.0, want[ok].abs().max().item())
    if dtype == torch.float64:
      assert err <= 1e-10 * scale, (k, err, scale)
    else:
      own = (p32.double() - want)[ok].abs().max().item()
      assert err <= max(1e-5 * scale, 4 * own), (k, err, own, scale)
  return rows, got


CARD_CASES = {
  "g1 shapes, 2% active": ((0, 37, 35, 1699), dict(ne=0, nf=0, active=0.02)),
  "cap edges": ((1, 7, 35, 400), dict(counts=[0, 1, 31, 127, 128, 129, 300])),
  "dense above cap": ((2, 5, 35, 260), dict(active=1.0)),
  "ragged 1": ((3, 9, 7, 1), dict(active=0.5)),
  "ragged 3": ((4, 9, 7, 3), dict(active=0.5)),
  "ragged 33": ((5, 9, 12, 33), dict(ne=1, nf=2, active=0.5)),
  "ragged 257": ((6, 9, 33, 257), dict(ne=3, nf=3, active=0.2)),
  "cones 3 4 6": ((7, 11, 20, 60), dict(ne=2, nf=3, cds=(3, 3, 4, 6, 6))),
  "many cone rows above cap": ((8, 6, 18, 20), dict(cds=(3,) * 40 + (6,) * 10)),
  "nv 64": ((9, 5, 64, 90), dict(ne=2, nf=2, cds=(3, 4))),
  "all inactive": ((10, 5, 11, 50), dict(ne=2, nf=2, cds=(3, 4), zero=True)),
  "warm start wins": ((17, 9, 35, 300), dict(ne=2, nf=3, cds=(3, 4), warm="better")),
  "a0 wins": ((18, 6, 35, 300), dict(ne=2, nf=3, cds=(3, 4), warm="far")),
  "warm start is a0": ((19, 6, 35, 300), dict(ne=2, nf=3, cds=(3, 4), warm="a0")),
  "NaN in the warm start": ((20, 6, 35, 300), dict(ne=2, nf=3, cds=(3, 4), warm="nan")),
}


def linesearch_gradient_differences(rows, x, p, ws, fn) -> list[str]:
  """The outputs of the warm start and of each linesearch launch at the
  point it returns (the gradient, w and the blocks; the forces) that differ
  by a bit from `fn`'s newton_gradient at that point."""
  bad = []
  x0, _, *at = fn["warm_start"](rows, ws)
  at = [None if t is None else t.clone() for t in at]
  for i, (a, b) in enumerate(zip(at, fn["gradient"](rows, x0))):
    if (a is None) != (b is None) or (a is not None and not newton.same_bits(a, b)):
      bad.append(f"warm start output {i}")
  for sg in (False, True) if rows.layout is not None else (False,):
    for forces in (False, True):
      xo, _, _, at = fn["linesearch"](rows, x, p, LS_STEPS, sg, forces=forces)
      at = [None if t is None else t.clone() for t in at]
      want = fn["gradient"](rows, xo, forces=forces)
      for i, (a, b) in enumerate(zip(at, want)):
        if (a is None) != (b is None) or (a is not None and not newton.same_bits(a, b)):
          bad.append(f"safeguard {sg} forces {forces} output {i}")
  return bad


def inactive_weights_after_iterations(rows, x, p, ws, fn, first="warm_start",
                                      iterations=3) -> torch.Tensor:
  """w on the rows that no launch lists (D = 0, and the cone rows) after the
  launch that lists them (`first`: the warm start from ws, or
  newton_gradient at x) and `iterations` linesearches along p, their buffer
  filled with NaN before the first launch."""
  newton._state(rows).w.fill_(float("nan"))
  if first == "warm_start":
    fn["warm_start"](rows, ws)
  else:
    fn["gradient"](rows, x)
  w = None
  for _ in range(iterations):
    x, _, _, (_, w, _) = fn["linesearch"](rows, x, p, LS_STEPS, rows.layout is not None)
  listed = rows.D != 0
  if rows.kind is not None:
    listed &= rows.kind != newton.CONE_ROW
  return w[~listed]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(case, dtype):
  _card()
  _check_on_card(CARD_CASES[case], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["g1 shapes, 2% active", "cap edges", "dense above cap",
                                  "cones 3 4 6", "many cone rows above cap", "warm start wins"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_linesearch_gradient_is_newton_gradient_bitwise_on_card(case, dtype):
  """The gradient, w and blocks (and the forces) that the warm start and a
  linesearch launch return at their point are bitwise newton_gradient's
  there."""
  _card()
  args, kw = CARD_CASES[case]
  assert not linesearch_gradient_differences(*problem(*args, **kw, dtype=dtype, device="cuda"),
                                             WRAPPED)


@pytest.mark.gpu
@pytest.mark.parametrize("first", ["warm_start", "gradient"])
@pytest.mark.parametrize("case", ["cap edges", "ragged 257", "cones 3 4 6"])
def test_w_is_zero_on_inactive_rows_after_iterations_on_card(case, first):
  _card()
  args, kw = CARD_CASES[case]
  rows, x, p, ws = problem(*args, **kw, device="cuda")
  w = inactive_weights_after_iterations(rows, x, 0.1 * p, ws, WRAPPED, first)
  assert w.numel() and torch.equal(w, torch.zeros_like(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_on_a_nan_direction_on_card(dtype):
  _card()
  rows, x, p, ws = problem(12, 4, 10, 40, ne=1, nf=2, cds=(3, 4), dtype=dtype, device="cuda")
  p[1, 3] = float("nan")
  newton.warm_start(rows, ws)
  for sg in (False, True):
    xo, alpha, improved, (g, _, _) = newton.newton_linesearch(rows, x, p, LS_STEPS, sg)
    xp, ap, ip, (gp, _, _) = linesearch_plain(rows, x, p, LS_STEPS, sg)
    assert torch.equal(torch.isnan(xo), torch.isnan(xp)) and torch.equal(improved, ip)
    assert torch.equal(torch.isnan(g), torch.isnan(gp))
    if not sg:
      assert torch.equal(xo[1], x[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_step_that_leaves_x_as_it_is_ties_on_card(dtype):
  """p so small that x + αp rounds to x: the candidate's cost is x's own,
  exactly, so the step is not taken, as on the CPU, and the gradient
  returned is x's."""
  _card()
  rows, x, p, _ = problem(15, 6, 10, 40, ne=1, nf=2, cds=(3, 4), dtype=dtype, device="cuda")
  p = p * 1e-30
  grad = newton.newton_gradient(rows, x)[0]
  for sg in (False, True):
    xo, _, improved, (g, _, _) = newton.newton_linesearch(rows, x, p, LS_STEPS, sg)
    assert not improved.any() and torch.equal(xo, x) and torch.equal(g, grad)


@pytest.mark.gpu
def test_kernels_on_a_grid_larger_than_the_card_holds_on_card():
  """8192 worlds: more than the card's resident one-warp blocks at once."""
  _card()
  _check_on_card(((13, 8192, 12, 40), dict(ne=1, nf=1, cds=(3,))), torch.float32)


@pytest.mark.gpu
def test_inactive_rows_garbage_changes_nothing_on_card():
  _card()
  a = outputs(*problem(14, 5, 9, 200, ne=2, nf=3, cds=(3, 4, 6), device="cuda"), WRAPPED)
  b = outputs(*problem(14, 5, 9, 200, ne=2, nf=3, cds=(3, 4, 6), device="cuda", garbage=True),
              WRAPPED)
  for k in a:
    assert same(a[k], b[k]), k


@pytest.mark.gpu
def test_linesearch_needs_the_solves_list_on_card():
  _card()
  rows, x, p, _ = problem(16, 3, 7, 20, device="cuda")
  with pytest.raises(ValueError, match="warm_start builds it"):
    newton.newton_linesearch(rows, x, p, LS_STEPS, False)


# The CPU emulation's problems (tests/test_torch_newton_iter_emu.py,
# tools/warp_emu/run.py): every class, cone dims, the caps' edges, a world
# past CAP, nv 64, no row active, warm starts that win, lose, equal a0 or
# hold a NaN (and each kind in every problem of 5 worlds or more); float64.
EMU_CASES = {
  "pyramidal": ((0, 3, 7, 20), {}),
  "equality and friction loss, nv 35": ((1, 3, 35, 60), dict(ne=4, nf=5)),
  "cone dims 3, 4, 6": ((2, 4, 12, 30), dict(ne=2, nf=3, cds=(3, 3, 4, 6))),
  "active counts 127-129 (the cap)": ((3, 3, 35, 300), dict(counts=[127, 128, 129])),
  "every row, nv 64": ((4, 2, 64, 131), dict(active=1.0)),
  "cone rows past the cap": ((5, 2, 33, 5), dict(cds=(6,) * 30)),
  "ragged m 13": ((6, 5, 9, 13), dict(ne=1)),
  "no row active": ((7, 2, 11, 40), dict(ne=2, nf=2, cds=(3, 4), zero=True)),
  "more than 32 slots, past both caps": ((8, 2, 10, 140), dict(cds=(3,) * 56, active=1.0)),
  "warm start wins": ((9, 3, 12, 30), dict(ne=2, nf=3, cds=(3, 4), warm="better")),
  "a0 wins": ((10, 3, 12, 30), dict(ne=2, nf=3, cds=(3, 4), warm="far")),
  "warm start is a0": ((11, 3, 12, 30), dict(ne=2, nf=3, cds=(3, 4), warm="a0")),
  "NaN in the warm start": ((12, 3, 12, 30), dict(ne=2, nf=3, cds=(3, 4), warm="nan")),
}
