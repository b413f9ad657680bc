"""MuJoCo's muscle model (mju_muscleGain, mju_muscleBias,
mju_muscleDynamics), elementwise over any leading shape (port of
mjlab_tpu/physics/muscle.py).

`prm` is an actuator's gainprm or biasprm cut to its first 9 entries
(`[..., :9]`: it may carry an env axis under domain randomization):
  0 range0, 1 range1: the operating length range in L0 units
  2 force: the peak active force (< 0: derived from scale / acc0)
  3 scale: the force scaling when force < 0
  4 lmin, 5 lmax: the active force-length curve's support
  6 vmax: the shortening velocity at which force-velocity reaches 0 (L0/s)
  7 fpmax: the passive force at lmax, in force units
  8 fvmax: the eccentric force plateau
`dynprm`: 0 tau_act, 1 tau_deact, 2 the smoothing width.
"""

from __future__ import annotations

import torch

_MINVAL = 1e-15


def _zeros(x: torch.Tensor) -> torch.Tensor:
  return torch.zeros_like(x)


def _bump(L, A, mid, B):
  """The piecewise-quadratic unit bump over [A, B], peaking at mid."""
  left = 0.5 * (A + mid)
  right = 0.5 * (mid + B)
  x_l = (L - A) / torch.clamp_min(left - A, _MINVAL)
  x_ml = (mid - L) / torch.clamp_min(mid - left, _MINVAL)
  x_mr = (L - mid) / torch.clamp_min(right - mid, _MINVAL)
  x_r = (B - L) / torch.clamp_min(B - right, _MINVAL)
  out = torch.where(
    L < left, 0.5 * x_l * x_l,
    torch.where(L < mid, 1.0 - 0.5 * x_ml * x_ml,
                torch.where(L < right, 1.0 - 0.5 * x_mr * x_mr, 0.5 * x_r * x_r)))
  return torch.where((L <= A) | (L >= B), _zeros(out), out)


def _norm_length(length, lengthrange, prm):
  r0, r1 = prm[..., 0], prm[..., 1]
  L0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp_min(r1 - r0, _MINVAL)
  L = r0 + (length - lengthrange[..., 0]) / torch.clamp_min(L0, _MINVAL)
  return L, L0


def _scaled_force(prm, acc0):
  force = prm[..., 2]
  return torch.where(force < 0, prm[..., 3] / torch.clamp_min(acc0, _MINVAL), force)


def muscle_gain(length, velocity, lengthrange, acc0, prm):
  """The active force-length-velocity force (negative pulls)."""
  lmin, lmax = prm[..., 4], prm[..., 5]
  vmax, fvmax = prm[..., 6], prm[..., 8]
  L, L0 = _norm_length(length, lengthrange, prm)
  V = velocity / torch.clamp_min(L0 * vmax, _MINVAL)
  force = _scaled_force(prm, acc0)
  FL = _bump(L, lmin, 1.0, lmax)
  y = fvmax - 1.0
  FV = torch.where(
    V <= -1.0, _zeros(V),
    torch.where(V <= 0.0, (V + 1.0) * (V + 1.0),
                torch.where(V <= y, fvmax - (y - V) * (y - V) / torch.clamp_min(y, _MINVAL),
                            fvmax)))
  return -force * FL * FV


def muscle_gain_vel(length, velocity, lengthrange, acc0, prm):
  """∂ muscle_gain / ∂ velocity: the force-velocity curve's slope, which
  MuJoCo's implicitfast takes into its velocity derivative (the JAX package
  has no counterpart, ROADMAP Queue C)."""
  lmin, lmax = prm[..., 4], prm[..., 5]
  vmax, fvmax = prm[..., 6], prm[..., 8]
  L, L0 = _norm_length(length, lengthrange, prm)
  scale = torch.clamp_min(L0 * vmax, _MINVAL)
  V = velocity / scale
  force = _scaled_force(prm, acc0)
  FL = _bump(L, lmin, 1.0, lmax)
  y = fvmax - 1.0
  dFV = torch.where(
    V <= -1.0, _zeros(V),
    torch.where(V <= 0.0, 2.0 * (V + 1.0),
                torch.where(V <= y, 2.0 * (y - V) / torch.clamp_min(y, _MINVAL), _zeros(V))))
  return -force * FL * dFV / scale


def muscle_bias(length, lengthrange, acc0, prm):
  """The passive force-length force (negative pulls)."""
  lmax, fpmax = prm[..., 5], prm[..., 7]
  L, _ = _norm_length(length, lengthrange, prm)
  force = _scaled_force(prm, acc0)
  b = 0.5 * (1.0 + lmax)
  x_mid = (L - 1.0) / torch.clamp_min(b - 1.0, _MINVAL)
  x_hi = (L - b) / torch.clamp_min(b - 1.0, _MINVAL)
  return torch.where(
    L <= 1.0, _zeros(L),
    torch.where(L <= b, -force * fpmax * 0.5 * x_mid * x_mid, -force * fpmax * (0.5 + x_hi)))


def _sigmoid(x):
  """The quintic smoothstep on [0, 1] (mju_sigmoid)."""
  xc = torch.clamp(x, 0.0, 1.0)
  s = xc * xc * xc * (3.0 * xc * (2.0 * xc - 5.0) + 10.0)
  return torch.where(x <= 0.0, _zeros(x), torch.where(x >= 1.0, torch.ones_like(x), s))


def muscle_dynamics(ctrl, act, dynprm):
  """act_dot of the smoothed activation dynamics."""
  tau_act, tau_deact, width = dynprm[..., 0], dynprm[..., 1], dynprm[..., 2]
  ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
  actclamp = torch.clamp(act, 0.0, 1.0)
  dctrl = ctrlclamp - act
  t_act = tau_act * (0.5 + 1.5 * actclamp)
  t_deact = tau_deact / (0.5 + 1.5 * actclamp)
  hard = torch.where(dctrl > 0.0, t_act, t_deact)
  # A smoothed switch: the smoothstep over dctrl in [-width/2, width/2].
  smooth = t_deact + (t_act - t_deact) * _sigmoid(dctrl / torch.clamp_min(width, _MINVAL) + 0.5)
  tau = torch.where(width < _MINVAL, hard, smooth)
  return dctrl / torch.clamp_min(tau, _MINVAL)
