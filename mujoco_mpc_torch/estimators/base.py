"""The estimator layer's state-space utilities.

Counterpart of mujoco_mpc_tpu/estimators/base.py (reference interface
mjpc/estimators/estimator.h:33-98: Initialize, Update(ctrl, sensor),
State, Covariance). An estimator here is a state object and an `update`
that returns the next one; the covariance lives in the tangent space of
the configuration manifold, of dimension 2 nv + na (`tangent_dim`).
`retract` applies a tangent displacement to qpos (qpos + dq on the joints'
manifolds), its inverse `local_diff` takes qa - qb as a tangent vector
(mju_differentiatePos with dt = 1), `pack_state` applies a whole state
tangent and `measurement_slice` finds the sensors an estimator measures.
Free and ball joints are handled exactly, as quaternion exponential and
log maps.

JAX loops over the joints in Python; here the joints' qpos and dof indices
are gathered once per Model (`Model.const`), so a call is a few gathers
and one quaternion difference for all quaternions at once, on any leading
batch dimensions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from mujoco_mpc_torch.ops.rollout import broadcast
from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics.step import integrate_pos
from mujoco_mpc_torch.physics.types import (Contact, Data, JointType, Model,
                                            SensorType)


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


def measurement_slice(m: Model):
  """(start, dim) of the sensordata an estimator measures: the non-USER
  sensors (USER sensors are the cost terms' placeholders, reference
  convention), or the `estimator_sensor_start` / `estimator_number_sensor`
  custom numerics where the model has them; those count sensors, not
  addresses."""
  start = m.custom("estimator_sensor_start", None)
  if start is not None:
    idx = int(start)
    nsens = m.custom("estimator_number_sensor", None)
    adr = m.sensor_spec[idx][3] if idx < len(m.sensor_spec) else 0
    if nsens is not None:
      last = idx + int(nsens) - 1
      end = m.sensor_spec[last][3] + m.sensor_spec[last][4]
      return adr, end - adr
    return adr, m.nsensordata - adr
  for (stype, _, _, adr, _dim) in m.sensor_spec:
    if SensorType(stype) != SensorType.USER:
      return adr, m.nsensordata - adr
  return 0, m.nsensordata


def measured(sensor: torch.Tensor, m: Model, start: int,
             ns: int) -> torch.Tensor:
  """The measurement: the slice [start, start + ns) of a whole
  sensordata vector, or `sensor` itself where it is not one."""
  return sensor[start:start + ns] if sensor.shape[0] == m.nsensordata \
      else sensor


def pack_state(m: Model, qpos, qvel, act, dx):
  """(qpos, qvel, act) (+) the tangent dx (..., 2 nv + na): the new
  (qpos, qvel, act), over dx's leading dimensions."""
  nv = m.nv
  qpos2 = retract(m, qpos, dx[..., :nv])
  qvel2 = qvel + dx[..., nv:2 * nv]
  act2 = act + dx[..., 2 * nv:] if m.na else act
  return qpos2, qvel2, act2


# forward-mode AD has one dual level per process, and a level entered
# while another thread's is open raises ("Nested forward mode AD is not
# supported"): the lock gives each pass its level alone, so that an
# estimation thread and a planning thread take turns
_DUAL_LOCK = threading.Lock()


@contextlib.contextmanager
def dual_level():
  """torch.autograd.forward_ad.dual_level(), one thread's at a time.
  Raises under torch.inference_mode, where dual tensors carry no tangent
  and every Jacobian would come out zero."""
  if torch.is_inference_mode_enabled():
    raise RuntimeError("forward-mode AD does not run under "
                       "torch.inference_mode (use torch.no_grad)")
  with _DUAL_LOCK, fwAD.dual_level():
    yield


def unit_tangents(n: int, like: torch.Tensor, batch=()) -> torch.Tensor:
  """batch + (n, n) dual zeros whose row j carries the unit tangent e_j:
  n states a batch entry, one forward-mode pass giving a Jacobian's n
  columns. Call inside dual_level()."""
  shape = tuple(batch) + (n, n)
  eye = torch.eye(n, dtype=like.dtype, device=like.device)
  return fwAD.make_dual(torch.zeros(shape, dtype=like.dtype,
                                    device=like.device),
                        eye.expand(shape).contiguous())


def perturbed(m: Model, d: Data, dx: torch.Tensor, **fields) -> Data:
  """d (+) dx over dx's leading batch (..., 2 nv + na): the state
  displaced by each tangent, the other fields broadcast (views), `fields`
  (one state's) replaced and broadcast."""
  batch = dx.shape[:-1]
  qpos, qvel, act = pack_state(m, d.qpos, d.qvel, d.act, dx)
  out = broadcast(d, batch).replace(
      qpos=qpos, qvel=qvel,
      **{k: v.expand(batch + v.shape) for k, v in fields.items()})
  return out.replace(act=act) if m.na else out


def _map_tensors(obj, fn):
  kw = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    if isinstance(v, Contact):
      v = _map_tensors(v, fn)
    elif isinstance(v, torch.Tensor):
      v = fn(v)
    kw[f.name] = v
  return dataclasses.replace(obj, **kw)


def primal_row(d: Data) -> Data:
  """Row 0 of a batched Data's primal values (forward-mode tangents
  dropped)."""
  return _map_tensors(d, lambda v: fwAD.unpack_dual(v).primal[0])


def tangent_of(x: torch.Tensor) -> torch.Tensor:
  """The forward-mode tangent of x (zeros where it carries none)."""
  t = fwAD.unpack_dual(x).tangent
  return torch.zeros_like(x) if t is None else t
