"""Quaternion and spatial (Plücker) algebra.

Counterpart of mujoco_mpc_tpu/physics/math.py. Conventions match MuJoCo:
quaternions (w, x, y, z); spatial 6-vectors [angular; linear] in the world
frame, moments about the world origin. Every function takes leading batch
dimensions and keeps the dtype. No function builds a tensor from host
values, so none copies to the card.
"""

from __future__ import annotations

import math as _pymath

import torch

# ----------------------------------------------------------------------------
# quaternions
# ----------------------------------------------------------------------------


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, broadcasting."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Dot product over the last axis, broadcasting."""
  return torch.sum(a * b, dim=-1)


def mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """m (..., 3, 3) times v (..., 3)."""
  return torch.matmul(m, v[..., None])[..., 0]


def mat_tvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """m^T (..., 3, 3) times v (..., 3)."""
  return torch.matmul(m.transpose(-1, -2), v[..., None])[..., 0]


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
  """x clamped to [lo, hi] as jnp.clip does it, a maximum then a minimum:
  at a bound the derivative is 1/2 (torch.clamp's is 1), which the
  derivative planners' Jacobians at saturated controls inherit."""
  return torch.minimum(torch.maximum(x, lo), hi)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u (x) v, as u's 4x4 left-multiplication matrix
  times v (three ops, where the sum of products takes some thirty)."""
  w, x, y, z = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
  n = -u
  nx, ny, nz = n[..., 1], n[..., 2], n[..., 3]
  left = torch.stack([w, nx, ny, nz,
                      x, w, nz, y,
                      y, z, w, nx,
                      z, ny, x, w], dim=-1).reshape(u.shape[:-1] + (4, 4))
  return torch.matmul(left, v[..., None])[..., 0]


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate v by q (body to world)."""
  w, u = q[..., :1], q[..., 1:]
  c1 = cross(u, v)
  c2 = cross(u, c1 + w * v)
  return v + 2.0 * c2


def quat_rot_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return quat_rot(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix of q: I + 2 (v v^T - |v|^2 I + w [v]x), v the
  vector part (the JAX package's entries, 1 - 2 (y^2 + z^2) on the
  diagonal and 2 (x y - w z) off it, as one expression of few ops)."""
  w, v = q[..., :1, None], q[..., 1:]
  vvt = v[..., :, None] * v[..., None, :]
  eye = torch.eye(3, dtype=q.dtype, device=q.device)
  vsq = torch.sum(v * v, dim=-1)[..., None, None]
  return eye + 2.0 * (vvt - vsq * eye + w * skew(v))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """Rotation matrix to quaternion, branch-free (the best-conditioned of
  Shepperd's four constructions), w >= 0."""
  tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
  q0 = torch.stack([1.0 + tr, m[..., 2, 1] - m[..., 1, 2],
                    m[..., 0, 2] - m[..., 2, 0],
                    m[..., 1, 0] - m[..., 0, 1]], dim=-1)
  q1 = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                    1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                    m[..., 0, 1] + m[..., 1, 0],
                    m[..., 0, 2] + m[..., 2, 0]], dim=-1)
  q2 = torch.stack([m[..., 0, 2] - m[..., 2, 0],
                    m[..., 0, 1] + m[..., 1, 0],
                    1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                    m[..., 1, 2] + m[..., 2, 1]], dim=-1)
  q3 = torch.stack([m[..., 1, 0] - m[..., 0, 1],
                    m[..., 0, 2] + m[..., 2, 0],
                    m[..., 1, 2] + m[..., 2, 1],
                    1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]],
                   dim=-1)
  cands = torch.stack([q0, q1, q2, q3], dim=-2)
  best = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
  idx = best[..., None, None].expand(*best.shape, 1, 4)
  q = torch.gather(cands, -2, idx)[..., 0, :]
  q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
  return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def axis_angle_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
  """Quaternion of a rotation by `angle` about the unit `axis`."""
  half = 0.5 * angle
  s = torch.sin(half)
  cos = torch.cos(half)[..., None]
  return torch.cat([cos, axis * s[..., None]], dim=-1)


def safe_norm(v: torch.Tensor, eps: float = 1e-12):
  """(norm (..., 1), unit): both 0-safe (a zero vector gives norm 0 and
  unit 0, with finite gradients)."""
  sq = torch.sum(v * v, dim=-1, keepdim=True)
  small = sq < eps * eps
  safe_sq = torch.where(small, torch.ones_like(sq), sq)
  n = torch.where(small, torch.zeros_like(sq), torch.sqrt(safe_sq))
  unit = v / torch.where(small, torch.ones_like(sq), torch.sqrt(safe_sq))
  return n, unit


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor,
                   dt) -> torch.Tensor:
  """Integrate a unit quaternion by the body-frame angular velocity for
  dt (the exact exponential map, mju_quatIntegrate). Below an angle of
  1e-12 the map is its first-order form (1, omega dt / 2), which equals
  the identity there to rounding and keeps the derivative in omega at
  omega = 0 (the JAX package's identity has none there: its iLQG
  Jacobians lose the rotation columns of free and ball joints)."""
  theta, axis = safe_norm(omega_local)
  dq = axis_angle_quat(axis, (theta * dt)[..., 0])
  first = torch.cat([torch.ones_like(theta), 0.5 * dt * omega_local], dim=-1)
  dq = torch.where(theta < 1e-12, first, dq)
  out = quat_mul(q, dq)
  return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """The 3-D velocity that takes qb to qa in unit time, in the local frame
  (mju_subQuat: the rotation vector of qb^-1 qa)."""
  dq = quat_mul(quat_conj(qb), qa)
  sin_half, unit = safe_norm(dq[..., 1:])
  angle = 2.0 * torch.atan2(sin_half[..., 0], dq[..., 0])[..., None]
  angle = torch.where(angle > _pymath.pi, angle - 2 * _pymath.pi, angle)
  return torch.where(sin_half < 1e-12, dq[..., 1:] * 2.0, unit * angle)


# ----------------------------------------------------------------------------
# spatial algebra: 6-vectors [angular; linear] about the world origin
# ----------------------------------------------------------------------------


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors v x m."""
  ang = cross(v[..., :3], m[..., :3])
  lin = cross(v[..., :3], m[..., 3:]) + cross(v[..., 3:], m[..., :3])
  return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product motion x force, v x* f."""
  ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
  lin = cross(v[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
  """[v]x, with [v]x u = v x u."""
  z = torch.zeros_like(v[..., 0])
  m = torch.stack([z, -v[..., 2], v[..., 1],
                   v[..., 2], z, -v[..., 0],
                   -v[..., 1], v[..., 0], z], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_com: torch.Tensor,
                    com: torch.Tensor) -> torch.Tensor:
  """6x6 spatial inertia about the world origin:
  [[I_c + m C C^T, m C], [m C^T, m 1]], C = skew(com)."""
  c = skew(com)
  eye = torch.eye(3, dtype=com.dtype, device=com.device)
  mm = mass[..., None, None]
  top = torch.cat([inertia_com + mm * (c @ c.transpose(-1, -2)), mm * c],
                  dim=-1)
  bot = torch.cat([mm * c.transpose(-1, -2),
                   (mm * eye).expand(c.shape)], dim=-1)
  return torch.cat([top, bot], dim=-2)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """v / sqrt(max(|v|^2, eps^2)) (finite gradients at v = 0)."""
  s = torch.sum(v * v, dim=-1, keepdim=True)
  return v / torch.sqrt(torch.clamp(s, min=eps * eps))
