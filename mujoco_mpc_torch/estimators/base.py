"""Tangent-space utilities of the configuration manifold.

Counterpart of mujoco_mpc_tpu/estimators/base.py, for what the derivative
planners need: `retract` (qpos + dq on the joints' manifolds), its inverse
`local_diff` (qa - qb as a tangent vector, mju_differentiatePos with
dt = 1) and `tangent_dim`. Free and ball joints are handled exactly, as
quaternion log maps. The estimators themselves are still to port.

JAX loops over the joints in Python; here the joints' qpos and dof indices
are gathered once per Model (`Model.const`), so a call is a few gathers
and one quaternion difference for all quaternions at once, on any leading
batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics.step import integrate_pos
from mujoco_mpc_torch.physics.types import JointType, Model


def retract(m: Model, qpos: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
  """qpos (+) dq: a tangent-space displacement applied on the manifold."""
  return integrate_pos(m, qpos, dq, 1.0)


def _diff_index(m: Model):
  """(qpos indices of the linear coordinates (nlin,), qpos indices of the
  quaternions (nquat, 4), the permutation that puts [linear differences,
  quaternion differences (nquat * 3)] in dof order), or None where every
  joint is a hinge or slide."""
  lin_q, lin_v, quat_q, quat_v = [], [], [], []
  for j in range(m.njnt):
    qadr, vadr, jt = m.jnt_qposadr[j], m.jnt_dofadr[j], m.jnt_type[j]
    if jt == JointType.FREE:
      lin_q += [qadr, qadr + 1, qadr + 2]
      lin_v += [vadr, vadr + 1, vadr + 2]
      quat_q.append(range(qadr + 3, qadr + 7))
      quat_v += [vadr + 3, vadr + 4, vadr + 5]
    elif jt == JointType.BALL:
      quat_q.append(range(qadr, qadr + 4))
      quat_v += [vadr, vadr + 1, vadr + 2]
    else:
      lin_q.append(qadr)
      lin_v.append(vadr)
  if not quat_q:
    return None
  dev = m.device
  perm = np.argsort(np.asarray(lin_v + quat_v))
  return (torch.tensor(lin_q, dtype=torch.long, device=dev),
          torch.tensor(np.asarray([list(r) for r in quat_q]),
                       dtype=torch.long, device=dev),
          torch.tensor(perm, dtype=torch.long, device=dev))


def local_diff(m: Model, qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """qa (-) qb -> (..., nv) tangent vector (mju_differentiatePos, dt 1);
  qa and qb (..., nq) broadcast against each other."""
  idx = m.const("local_diff_index", lambda: _diff_index(m))
  if idx is None:
    return qa - qb
  lin_q, quat_q, perm = idx
  lin = qa[..., lin_q] - qb[..., lin_q]
  rot = pmath.quat_sub(qa[..., quat_q], qb[..., quat_q])
  return torch.cat([lin, rot.flatten(-2)], dim=-1)[..., perm]


def tangent_dim(m: Model) -> int:
  return 2 * m.nv + m.na
