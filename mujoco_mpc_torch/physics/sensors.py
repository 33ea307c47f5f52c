"""Sensor evaluation, and the sensor quantities task residuals read.

Counterpart of mujoco_mpc_tpu/physics/sensors.py. The helpers work on
component-leading, batch-trailing tensors ((3, B) vectors, the tile view
of physics/tilestep.py::step_tb, or types.batch_trailing of a general
Data) as well as on single (3,) vectors. Model scalars they fold in come
from a host copy of the model, read once, so a residual on the card reads
nothing back from it. USER sensors are cost-term slots that `sensors`
leaves as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_torch.physics import math
from mujoco_mpc_torch.physics.types import (Data, Model, ObjType,
                                            SensorType, batch_trailing)


def _host(m: Model) -> dict:
  """Host (numpy) copies of the model arrays the helpers fold in."""
  return m.const("sensors_host", lambda: {
      k: getattr(m, k).detach().cpu().numpy().astype(np.float64)
      for k in ("body_mass", "body_subtreemass", "body_inertia")})


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
  host = _host(m)
  mom = None
  for b in _descendants(m, body):
    term = float(host["body_mass"][b]) * _point_vel(d, b, d.xipos[b])
    mom = term if mom is None else mom + term
  return mom / max(float(host["body_subtreemass"][body]), 1e-12)


def subtree_angmom(m: Model, d, body: int):
  """Angular momentum of the subtree about its centre of mass
  (mjSENS_SUBTREEANGMOM): the sum over its bodies of
  R diag(I) R^T omega + m (x - com) x v."""
  host = _host(m)
  com = d.subtree_com[body]
  val = None
  for b in _descendants(m, body):
    omega = d.cvel[b][:3]
    vcom = _point_vel(d, b, d.xipos[b])
    rot = d.ximat[b]  # (3, 3, ...)
    loc = [sum(rot[k, i] * omega[k] for k in range(3)) for i in range(3)]
    iloc = [float(host["body_inertia"][b][i]) * loc[i] for i in range(3)]
    spin = torch.stack([sum(rot[i, j] * iloc[j] for j in range(3))
                        for i in range(3)])
    term = spin + float(host["body_mass"][b]) * cross0(d.xipos[b] - com,
                                                       vcom)
    val = term if val is None else val + term
  return val


def _frame(m: Model, d, objtype: int, objid: int):
  """(pos, rot, body) of a sensor's attachment object, batch-trailing."""
  if objtype == ObjType.SITE:
    return d.site_xpos[objid], d.site_xmat[objid], m.site_bodyid[objid]
  if objtype == ObjType.GEOM:
    return d.geom_xpos[objid], d.geom_xmat[objid], m.geom_bodyid[objid]
  return d.xpos[objid], d.xmat[objid], objid  # BODY, XBODY


def mat_tvec0(mat, v):
  """mat^T v with the matrix axes leading: mat (3, 3, ...), v (3, ...)."""
  return torch.stack([sum(mat[k, i] * v[k] for k in range(3))
                      for i in range(3)])


def sub_const0(x, c):
  """x - c over leading axis 0, where c is a model constant: a tensor of
  x's leading size, or a numpy array, tuple or list (cast to x's dtype
  and device)."""
  c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
  return x - c.reshape(c.shape + (1,) * (x.dim() - 1))


def sensors(m: Model, d: Data) -> Data:
  """d with sensordata filled for every supported sensor type (the
  others, and USER slots, keep their values)."""
  if m.nsensordata == 0:
    return d
  nb = d.qpos.dim() - 1
  v = batch_trailing(d)
  out = []
  end = 0
  for stype, objtype, objid, adr, dim in m.sensor_spec:
    if adr > end:
      out.append(v.sensordata[end:adr])
    end = adr + dim
    st = SensorType(stype)
    val = None
    if st == SensorType.JOINTPOS:
      val = v.qpos[m.jnt_qposadr[objid]][None]
    elif st == SensorType.JOINTVEL:
      val = v.qvel[m.jnt_dofadr[objid]][None]
    elif st == SensorType.FRAMEPOS:
      val = _frame(m, v, objtype, objid)[0]
    elif st == SensorType.FRAMEQUAT:
      rot = _frame(m, v, objtype, objid)[1]
      val = torch.movedim(math.mat_to_quat(torch.movedim(
          torch.movedim(rot, 0, -1), 0, -1)), -1, 0)
    elif st in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS,
                SensorType.FRAMEZAXIS):
      rot = _frame(m, v, objtype, objid)[1]
      val = rot[:, int(st) - int(SensorType.FRAMEXAXIS)]
    elif st == SensorType.FRAMELINVEL:
      pos, _, body = _frame(m, v, objtype, objid)
      val = _point_vel(v, body, pos)
    elif st == SensorType.FRAMEANGVEL:
      val = v.cvel[_frame(m, v, objtype, objid)[2]][:3]
    elif st == SensorType.SUBTREECOM:
      val = v.subtree_com[objid]
    elif st == SensorType.SUBTREELINVEL:
      val = subtree_linvel(m, v, objid)
    elif st == SensorType.SUBTREEANGMOM:
      val = subtree_angmom(m, v, objid)
    elif st == SensorType.ACTUATORFRC:
      val = v.actuator_force[objid][None]
    elif st == SensorType.GYRO:
      _, rot, body = _frame(m, v, objtype, objid)
      val = mat_tvec0(rot, v.cvel[body][:3])
    elif st == SensorType.TOUCH:
      # normal force on the geoms of the site's body
      body = m.site_bodyid[objid]
      on = [i for i, (g1, g2) in enumerate(v.contact.pairs)
            if m.geom_bodyid[g1] == body or m.geom_bodyid[g2] == body]
      val = (sum(v.contact.force[i, 0] for i in on) if on
             else torch.zeros_like(v.sensordata[adr]))[None]
    elif st == SensorType.ACCELEROMETER:
      # gravity only, at the position stage (as the JAX package)
      _, rot, _ = _frame(m, v, objtype, objid)
      g = m.opt.gravity.to(rot.dtype).reshape((3,) + (1,) * nb)
      val = -mat_tvec0(rot, g + torch.zeros_like(rot[0]))
    if val is None:  # USER and unsupported: keep the slot
      val = v.sensordata[adr:end]
    out.append(val.to(v.sensordata.dtype).expand(
        (dim,) + v.sensordata.shape[1:]))
  if end < m.nsensordata:
    out.append(v.sensordata[end:])
  data = torch.cat(out, dim=0)
  return d.replace(sensordata=torch.movedim(data, 0, -1) if nb else data)
