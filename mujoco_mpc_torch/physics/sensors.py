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
