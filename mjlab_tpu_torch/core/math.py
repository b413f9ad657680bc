"""Quaternion, frame and sampling helpers the physics step and the MDP
terms use (port of the matching part of mjlab_tpu/core/math.py).
Quaternions are wxyz; every function broadcasts over leading axes and works
on the trailing one. Random draws take an explicit torch.Generator."""

from __future__ import annotations

import math

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


# ---------------------------------------------------------------------------
# Helpers the MDP terms use (port of the matching part of
# mjlab_tpu/core/math.py).
# ---------------------------------------------------------------------------


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
  """Wrap angles to [-pi, pi) (floor modulo, as jnp.mod)."""
  return torch.remainder(angle + torch.pi, 2 * torch.pi) - torch.pi


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
  """Inverse of a unit quaternion (= conjugate)."""
  return quat_conjugate(q)


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate v by q⁻¹ (world → local for a frame rotation q)."""
  return quat_apply(quat_conjugate(q), v)


def quat_unique(q: torch.Tensor) -> torch.Tensor:
  """Canonical sign: non-negative scalar part."""
  return torch.where(q[..., 0:1] < 0, -q, q)


def quat_error_magnitude(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Geodesic angle between two orientations."""
  dq = quat_mul(quat_conjugate(q1), q2)
  sin_half = torch.linalg.vector_norm(dq[..., 1:4], dim=-1)
  cos_half = torch.abs(dq[..., 0])
  return 2.0 * torch.atan2(sin_half, cos_half)


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
  """The yaw-only rotation of q (rotation about world z)."""
  w, x, y, z = q.unbind(-1)
  yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
  half = 0.5 * yaw
  zeros = torch.zeros_like(half)
  return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def subtract_frame_transforms(
  t01: torch.Tensor, q01: torch.Tensor, t02: torch.Tensor, q02: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
  """Relative transform: frame 2 expressed in frame 1."""
  qinv = quat_conjugate(q01)
  return quat_apply(qinv, t02 - t01), quat_mul(qinv, q02)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """Unit quaternion from rotation matrix, branch-free (Shepperd's method)."""
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  tr = m00 + m11 + m22
  qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
  qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
  qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
  qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
  scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
  best = torch.argmax(scores, dim=-1)
  cands = torch.stack([qw, qx, qy, qz], dim=-2)
  q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
  return quat_unique(normalize(q))


def quat_from_euler_xyz(
  roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor
) -> torch.Tensor:
  """Quaternion from intrinsic XYZ Euler angles: qz ⊗ qy ⊗ qx."""
  roll, pitch, yaw = torch.broadcast_tensors(roll, pitch, yaw)
  zero = torch.zeros_like(roll)

  def about(angle, axis):
    half = 0.5 * angle
    c, s = torch.cos(half), torch.sin(half)
    parts = [c, zero, zero, zero]
    parts[1 + axis] = s
    return torch.stack(parts, dim=-1)

  return quat_mul(about(yaw, 2), quat_mul(about(pitch, 1), about(roll, 0)))


def sample_uniform(lo, hi, shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
  """Uniform draws in [lo, hi) as lo + u (hi − lo); lo and hi are numbers
  or tensors broadcasting against `shape`."""
  u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
  return lo + u * (hi - lo)


def sample_gaussian(mean, std, shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
  return torch.randn(shape, generator=generator, dtype=dtype, device=device) * std + mean


def sample_log_uniform(lo, hi, shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
  u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
  return torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
