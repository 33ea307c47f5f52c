"""Sensor quantities that task residuals read.

Counterpart of the parts of mujoco_mpc_tpu/physics/sensors.py that the
ported residuals use. Every function works on component-leading,
batch-trailing tensors ((3, B) vectors, the tile view of
physics/tilestep.py::step_tb) as well as on single (3,) vectors.
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch.physics.types import Model


def cross0(a, b):
  """Cross product over the leading axis."""
  return torch.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]])


def dot0(a, b):
  """Dot product over the leading axis, summed in index order."""
  return sum(a[i] * b[i] for i in range(a.shape[0]))


def norm0(a, eps=1e-24):
  """Euclidean norm over the leading axis, clamped at eps inside the
  square root."""
  return torch.sqrt(torch.clamp(dot0(a, a), min=eps))


def quat_mul0(u, v):
  """Quaternion product over the leading axis ((4, ...) each)."""
  w1, x1, y1, z1 = u[0], u[1], u[2], u[3]
  w2, x2, y2, z2 = v[0], v[1], v[2], v[3]
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ])


def quat_sub0(qa, qb):
  """Orientation error of qa relative to qb, (3, ...): the sin-weighted
  surrogate 2 sign(w) vec(qb^-1 qa) = axis 2 sin(theta/2) of the JAX
  package (not mju_subQuat's log map)."""
  qbc = torch.stack([qb[0], -qb[1], -qb[2], -qb[3]])
  dq = quat_mul0(qbc, qa)
  s = torch.where(dq[0] < 0, -2.0, 2.0).to(dq.dtype)  # shortest path
  return torch.stack([dq[1] * s, dq[2] * s, dq[3] * s])


def _descendants(m: Model, root: int):
  """Bodies of the subtree rooted at `root`, itself included."""
  out = []
  for b in range(root, m.nbody):
    p = b
    while p > root:
      p = m.body_parentid[p]
    if p == root:
      out.append(b)
  return out


def _point_vel(d, body: int, point):
  """World linear velocity of a point fixed to `body` (world-origin
  cvel)."""
  v = d.cvel[body]
  return v[3:] + cross0(v[:3], point)


def subtree_linvel(m: Model, d, body: int):
  """Linear velocity of the subtree's centre of mass: momentum over
  subtree mass (mjSENS_SUBTREELINVEL)."""
  mom = None
  for b in _descendants(m, body):
    term = float(m.body_mass[b]) * _point_vel(d, b, d.xipos[b])
    mom = term if mom is None else mom + term
  return mom / max(float(m.body_subtreemass[body]), 1e-12)


def subtree_angmom(m: Model, d, body: int):
  """Angular momentum of the subtree about its centre of mass
  (mjSENS_SUBTREEANGMOM): the sum over its bodies of
  R diag(I) R^T omega + m (x - com) x v."""
  com = d.subtree_com[body]
  val = None
  for b in _descendants(m, body):
    omega = d.cvel[b][:3]
    vcom = _point_vel(d, b, d.xipos[b])
    rot = d.ximat[b]  # (3, 3, ...)
    loc = [sum(rot[k, i] * omega[k] for k in range(3)) for i in range(3)]
    iloc = [float(m.body_inertia[b][i]) * loc[i] for i in range(3)]
    spin = torch.stack([sum(rot[i, j] * iloc[j] for j in range(3))
                        for i in range(3)])
    term = spin + float(m.body_mass[b]) * cross0(d.xipos[b] - com, vcom)
    val = term if val is None else val + term
  return val
