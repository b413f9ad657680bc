"""Quaternion and frame helpers the physics step uses (port of the matching
part of mjlab_tpu/core/math.py). Quaternions are wxyz; every function
broadcasts over leading axes and works on the trailing one."""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
  """Normalize along the last axis, safe at zero norm."""
  n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
  return x / torch.clamp_min(n, eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, broadcasting like jnp.cross."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u ⊗ v."""
  uw, ux, uy, uz = u.unbind(-1)
  vw, vx, vy, vz = v.unbind(-1)
  return torch.stack(
    [
      uw * vw - ux * vx - uy * vy - uz * vz,
      uw * vx + ux * vw + uy * vz - uz * vy,
      uw * vy - ux * vz + uy * vw + uz * vx,
      uw * vz + ux * vy - uy * vx + uz * vw,
    ],
    dim=-1,
  )


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by quaternion q (active rotation), Rodrigues form."""
  s, u = q[..., 0:1], q[..., 1:4]
  t = 2.0 * cross(u, v)
  return v + s * t + cross(u, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Rotation matrix (..., 3, 3) from unit quaternion."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack(
    [
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ],
    dim=-1,
  )
  return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Quaternion from unit axis (..., 3) and angle (...,)."""
  half = 0.5 * angle
  return torch.cat(
    [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1
  )


def quat_exp(v: torch.Tensor) -> torch.Tensor:
  """Exponential map so(3) → unit quaternion, v = axis * angle."""
  angle = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
  small = angle < 1e-9
  axis = v / torch.where(small, torch.ones_like(angle), angle)
  half = 0.5 * angle[..., 0]
  q = torch.cat(
    [torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1
  )
  q_small = torch.cat([torch.ones_like(half)[..., None], 0.5 * v], dim=-1)
  return torch.where(small, normalize(q_small), q)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
  """q ⊗ exp(omega * dt), omega in the body frame (mju_quatIntegrate)."""
  return normalize(quat_mul(q, quat_exp(omega * dt)))
