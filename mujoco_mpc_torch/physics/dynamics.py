"""Smooth multibody dynamics: motion subspaces, velocities, the joint-space
inertia (CRB), bias forces (RNE), passive forces and actuation.

Counterpart of mujoco_mpc_tpu/physics/dynamics.py: Featherstone spatial
algebra with 6-vectors about the fixed world origin. Tree sums are products
with the model's static ancestor masks, so a step's ops do not grow with
the tree's depth; the batch rides the leading dimensions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mujoco_mpc_torch.physics import math
from mujoco_mpc_torch.physics.types import (ActDyn, Data, GainBias,
                                            JointType, Model, TrnType)


def _t(m: Model, key, array, dtype=None) -> torch.Tensor:
  """A constant of the model's static structure on its device, once."""
  return m.const((key, dtype), lambda: torch.as_tensor(
      np.asarray(array), dtype=dtype, device=m.device))


def _mask(m: Model, name: str, dtype) -> torch.Tensor:
  return m.const((name, dtype), lambda: getattr(m, name).to(dtype))


def _cdof_selectors(m: Model):
  """Per-dof (body, joint, world axis column, kind): kind 0 slide, 1
  hinge, 2 ball rotation, 3 free translation, 4 free rotation."""
  bid, jid, col, kind = [], [], [], []
  for j in range(m.njnt):
    b, jt = m.jnt_bodyid[j], m.jnt_type[j]
    if jt == JointType.FREE:
      for k in (3, 4):
        for i in range(3):
          bid.append(b), jid.append(j), col.append(i), kind.append(k)
    elif jt == JointType.BALL:
      for i in range(3):
        bid.append(b), jid.append(j), col.append(i), kind.append(2)
    else:
      bid.append(b), jid.append(j), col.append(0)
      kind.append(0 if jt == JointType.SLIDE else 1)
  return (np.asarray(bid), np.asarray(jid), np.asarray(col),
          np.asarray(kind))


def com_pos(m: Model, d: Data) -> Data:
  """Motion subspace cdof (nv, 6) of every dof, world-origin frame."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  if m.nv == 0:
    return d.replace(cdof=d.qpos.new_zeros(batch + (0, 6)))
  bid, jid, col, kind = _cdof_selectors(m)
  bid_t = _t(m, "cdof_bid", bid, torch.long)
  jid_t = _t(m, "cdof_jid", jid, torch.long)
  e_col = _t(m, "cdof_ecol", np.eye(3)[col], dtype)  # (nv, 3)
  is_slide = _t(m, "cdof_slide", (kind == 0)[:, None])
  is_hinge = _t(m, "cdof_hinge", (kind == 1)[:, None])
  is_trans = _t(m, "cdof_trans", (kind == 3)[:, None])
  is_rot = _t(m, "cdof_rot", ((kind == 2) | (kind == 4))[:, None])
  free_rot = _t(m, "cdof_freerot", (kind == 4)[:, None])
  xaxis_d = d.xaxis[..., jid_t, :]
  rot_axis = torch.einsum("...vij,vj->...vi", d.xmat[..., bid_t, :, :], e_col)
  anchor = torch.where(free_rot, d.xpos[..., bid_t, :],
                       d.xanchor[..., jid_t, :])
  zero = torch.zeros((), dtype=dtype, device=d.qpos.device)
  ang = torch.where(is_hinge, xaxis_d, zero) + torch.where(is_rot, rot_axis,
                                                           zero)
  lin = (torch.where(is_trans, e_col, zero) +
         torch.where(is_slide, xaxis_d, zero) +
         torch.where(is_hinge | is_rot, math.cross(anchor, ang), zero))
  return d.replace(cdof=torch.cat([ang, lin], dim=-1))


def com_vel(m: Model, d: Data) -> Tuple[Data, torch.Tensor]:
  """Body spatial velocities cvel (nbody, 6) and cdof_dot (nv, 6)."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  if m.nv == 0:
    return (d.replace(cvel=d.qpos.new_zeros(batch + (m.nbody, 6))),
            d.qpos.new_zeros(batch + (0, 6)))
  contrib = d.cdof * d.qvel[..., None]
  body_dof = m.const(("body_dof", dtype),
                     lambda: m.dof_body_mask.T.to(dtype).contiguous())
  cvel = body_dof @ contrib
  vk = _mask(m, "cdofdot_vel_mask", dtype) @ contrib
  return d.replace(cvel=cvel), math.motion_cross(vk, d.cdof)


def body_inertias(m: Model, d: Data) -> torch.Tensor:
  """(nbody, 6, 6) world-origin spatial inertia of each body."""
  dtype = d.qpos.dtype
  inertia_world = torch.einsum("...bij,bj,...bkj->...bik", d.ximat,
                               m.body_inertia.to(dtype), d.ximat)
  return math.spatial_inertia(m.body_mass.to(dtype), inertia_world, d.xipos)


def crb(m: Model, d: Data, ibody=None) -> Data:
  """Dense joint-space inertia qM through the ancestor masks."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  if m.nv == 0:
    return d.replace(qM=d.qpos.new_zeros(batch + (0, 0)))
  if ibody is None:
    ibody = body_inertias(m, d)
  ic_dof = (_mask(m, "dof_body_mask", dtype) @
            ibody.reshape(batch + (m.nbody, 36))).reshape(
                batch + (m.nv, 6, 6))
  f = torch.einsum("...jab,...jb->...ja", ic_dof, d.cdof)
  raw = d.cdof @ f.transpose(-1, -2)
  upper = torch.where(m.dof_ancestor_mask, raw, torch.zeros_like(raw))
  qm = (upper + upper.transpose(-1, -2)
        - torch.diag_embed(torch.diagonal(upper, dim1=-2, dim2=-1)))
  return d.replace(qM=qm + torch.diag(m.dof_armature.to(dtype)))


def rne(m: Model, d: Data, cdof_dot: torch.Tensor, ibody=None) -> Data:
  """Bias force qfrc_bias = C(q, v) v + g (recursive Newton-Euler)."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  if m.nv == 0:
    return d.replace(qfrc_bias=d.qpos.new_zeros(batch + (0,)))
  if ibody is None:
    ibody = body_inertias(m, d)
  grav = torch.cat([torch.zeros_like(m.opt.gravity),
                    -m.opt.gravity]).to(dtype)
  body_dof = m.const(("body_dof", dtype),
                     lambda: m.dof_body_mask.T.to(dtype).contiguous())
  cacc = grav + body_dof @ (cdof_dot * d.qvel[..., None])
  fv = torch.einsum("...bij,...bj->...bi", ibody, d.cvel)
  cfrc = (torch.einsum("...bij,...bj->...bi", ibody, cacc) +
          math.force_cross(d.cvel, fv))
  qfrc_bias = torch.sum(
      d.cdof * (_mask(m, "dof_body_mask", dtype) @ cfrc), dim=-1)
  return d.replace(qfrc_bias=qfrc_bias)


def _project_body_forces(m: Model, d: Data, fs: torch.Tensor):
  """qfrc (nv,) of spatial body forces fs (nbody, 6) about the origin."""
  proj = d.cdof @ fs.transpose(-1, -2)  # (nv, nbody)
  return torch.sum(torch.where(m.dof_body_mask, proj,
                               torch.zeros_like(proj)), dim=-1)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """The applied body wrenches [torque; force] at the CoM as qfrc (nv,)."""
  if m.nv == 0 or m.nbody <= 1:
    return d.qpos.new_zeros(d.qpos.shape[:-1] + (m.nv,))
  torque = d.xfrc_applied[..., :3]
  force = d.xfrc_applied[..., 3:]
  fs = torch.cat([torque + math.cross(d.xipos, force), force], dim=-1)
  return _project_body_forces(m, d, fs)


def _fluid_forces(m: Model, d: Data) -> torch.Tensor:
  """Viscous and quadratic drag of each body's equivalent inertia box
  (MuJoCo's inertia-box fluid model)."""
  dtype = d.qpos.dtype
  mass = torch.clamp(m.body_mass.to(dtype), min=1e-12)
  inertia = m.body_inertia.to(dtype)
  ix, iy, iz = inertia[:, 0], inertia[:, 1], inertia[:, 2]
  box = torch.sqrt(torch.clamp(torch.stack([
      1.5 * (iy + iz - ix), 1.5 * (iz + ix - iy), 1.5 * (ix + iy - iz),
  ], dim=-1), min=1e-12) / mass[:, None])
  opt = m.opt
  omega_w = d.cvel[..., :3]
  vlin_w = (d.cvel[..., 3:] + math.cross(omega_w, d.xipos) -
            opt.wind.to(dtype))
  rot = d.ximat
  rot_t = rot.transpose(-1, -2)
  omega = torch.einsum("...bij,...bj->...bi", rot_t, omega_w)
  vlin = torch.einsum("...bij,...bj->...bi", rot_t, vlin_w)
  diam = 2.0 * torch.mean(box, dim=-1)
  visc, dens = opt.viscosity.to(dtype), opt.density.to(dtype)
  f_visc = -3.0 * np.pi * visc * diam[:, None] * vlin
  t_visc = -np.pi * (diam ** 3)[:, None] * visc * omega
  area = 4.0 * torch.stack([box[:, 1] * box[:, 2], box[:, 0] * box[:, 2],
                            box[:, 0] * box[:, 1]], dim=-1)
  f_dens = -0.5 * dens * area * torch.abs(vlin) * vlin
  bj = torch.stack([box[:, 1], box[:, 2], box[:, 0]], dim=-1)
  bk = torch.stack([box[:, 2], box[:, 0], box[:, 1]], dim=-1)
  t_coef = bj * bk * (bj ** 4 + bk ** 4) / 64.0
  t_dens = -dens * t_coef * torch.abs(omega) * omega
  force_w = torch.einsum("...bij,...bj->...bi", rot, f_visc + f_dens)
  torque_w = torch.einsum("...bij,...bj->...bi", rot, t_visc + t_dens)
  fs = torch.cat([torque_w + math.cross(d.xipos, force_w), force_w], dim=-1)
  return _project_body_forces(m, d, fs)


def tendon_jacobian_np(m: Model) -> np.ndarray:
  """(ntendon, nv) constant moment rows of the fixed tendons."""
  jac = np.zeros((m.ntendon, m.nv), dtype=np.float32)
  for t, wraps in enumerate(m.tendon_joints):
    for jid, coef in wraps:
      jac[t, m.jnt_dofadr[jid]] += coef
  return jac


def tendon_lengths(m: Model, d: Data):
  """(length, velocity) of the fixed tendons, each (ntendon,)."""
  lens, vels = [], []
  for wraps in m.tendon_joints:
    ln = vl = 0.0
    for jid, coef in wraps:
      ln = ln + coef * d.qpos[..., m.jnt_qposadr[jid]]
      vl = vl + coef * d.qvel[..., m.jnt_dofadr[jid]]
    lens.append(ln)
    vels.append(vl)
  return torch.stack(lens, dim=-1), torch.stack(vels, dim=-1)


def passive(m: Model, d: Data) -> Data:
  """Springs, dampers, fluid drag and the smoothed joint friction loss."""
  dtype = d.qpos.dtype
  if m.nv == 0:
    return d.replace(qfrc_passive=d.qpos.new_zeros(d.qpos.shape[:-1] + (0,)))
  qfrc = -m.dof_damping.to(dtype) * d.qvel
  if m.opt.has_fluid:
    qfrc = qfrc + _fluid_forces(m, d)
  if m.has_frictionloss:
    qfrc = qfrc - m.dof_frictionloss.to(dtype) * torch.tanh(d.qvel / 0.01)
  if m.ntendon:
    jten = _t(m, "tendon_jac", tendon_jacobian_np(m), dtype)
    ln, vl = tendon_lengths(m, d)
    lo = m.tendon_lengthspring[:, 0].to(dtype)
    hi = m.tendon_lengthspring[:, 1].to(dtype)
    zero = torch.zeros_like(ln)
    stretch = torch.where(ln > hi, ln - hi,
                          torch.where(ln < lo, ln - lo, zero))
    f_ten = (-m.tendon_stiffness.to(dtype) * stretch -
             m.tendon_damping.to(dtype) * vl)
    qfrc = qfrc + f_ten @ jten
  if not m.has_spring:
    return d.replace(qfrc_passive=qfrc)
  # joint springs about qpos_spring, dof by dof
  spring = [torch.zeros_like(d.qvel[..., 0])] * m.nv
  qs = m.qpos_spring.to(dtype)
  k_all = m.jnt_stiffness.to(dtype)
  for j in range(m.njnt):
    qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
    jt, k = m.jnt_type[j], k_all[j]
    if jt in (JointType.HINGE, JointType.SLIDE):
      spring[vadr] = spring[vadr] - k * (d.qpos[..., qadr] - qs[qadr])
    elif jt == JointType.BALL:
      dq = -k * math.quat_sub(d.qpos[..., qadr:qadr + 4],
                              qs[qadr:qadr + 4])
      for i in range(3):
        spring[vadr + i] = spring[vadr + i] + dq[..., i]
    elif jt == JointType.FREE:
      dp = -k * (d.qpos[..., qadr:qadr + 3] - qs[qadr:qadr + 3])
      dq = -k * math.quat_sub(d.qpos[..., qadr + 3:qadr + 7],
                              qs[qadr + 3:qadr + 7])
      for i in range(3):
        spring[vadr + i] = spring[vadr + i] + dp[..., i]
        spring[vadr + 3 + i] = spring[vadr + 3 + i] + dq[..., i]
  return d.replace(qfrc_passive=qfrc + torch.stack(spring, dim=-1))


def _site_moment(m: Model, d: Data, u: int) -> torch.Tensor:
  """(nv,) moment of a site-transmission actuator at unit force: gear
  [force; torque] in the site frame."""
  dtype = d.qpos.dtype
  sid = m.actuator_trnid[u]
  b = m.site_bodyid[sid]
  rot = d.site_xmat[..., sid, :, :]
  gear = m.actuator_gear[u].to(dtype)
  force = math.mat_vec(rot, gear[:3].expand(rot.shape[:-1]))
  torque = math.mat_vec(rot, gear[3:].expand(rot.shape[:-1]))
  fs = torch.cat([torque + math.cross(d.site_xpos[..., sid, :], force),
                  force], dim=-1)
  proj = torch.sum(d.cdof * fs[..., None, :], dim=-1)
  return torch.where(m.dof_body_mask[:, b], proj, torch.zeros_like(proj))


def _partition(m: Model):
  """Actuators on scalar joints (vectorized) and the others."""
  scalar_u, other_u = [], []
  for u in range(m.nu):
    j = m.actuator_trnid[u]
    if (m.actuator_trntype[u] == TrnType.JOINT and
        m.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)):
      scalar_u.append(u)
    else:
      other_u.append(u)
  return scalar_u, other_u


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces to qfrc_actuator, and the activations' act_dot."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  if m.nu == 0:
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel),
                     actuator_force=d.qpos.new_zeros(batch + (0,)),
                     act_dot=torch.zeros_like(d.act))
  crange = m.actuator_ctrlrange.to(dtype)
  ctrl = torch.where(m.actuator_ctrllimited,
                     math.clip(d.ctrl, crange[:, 0], crange[:, 1]), d.ctrl)
  gear_all = m.actuator_gear.to(dtype)
  scalar_u, other_u = _partition(m)

  length = [None] * m.nu
  velocity = [None] * m.nu
  if scalar_u:
    uidx = _t(m, "act_scalar_u", scalar_u, torch.long)
    qadr = _t(m, "act_scalar_q", [m.jnt_qposadr[m.actuator_trnid[u]]
                                  for u in scalar_u], torch.long)
    vadr = _t(m, "act_scalar_v", [m.jnt_dofadr[m.actuator_trnid[u]]
                                  for u in scalar_u], torch.long)
    gear = gear_all[uidx, 0]
    lens = gear * d.qpos[..., qadr]
    vels = gear * d.qvel[..., vadr]
    for k, u in enumerate(scalar_u):
      length[u], velocity[u] = lens[..., k], vels[..., k]

  zero = torch.zeros_like(d.qpos[..., 0])
  other_moments = {}
  ten = None
  for u in other_u:
    if m.actuator_trntype[u] == TrnType.TENDON:
      if ten is None:
        ten = tendon_lengths(m, d)
        jten = _t(m, "tendon_jac", tendon_jacobian_np(m), dtype)
      tid = m.actuator_trnid[u]
      g0 = gear_all[u, 0]
      other_moments[u] = g0 * jten[tid]
      length[u] = g0 * ten[0][..., tid]
      velocity[u] = g0 * ten[1][..., tid]
    elif m.actuator_trntype[u] == TrnType.JOINT:  # ball / free rotary gear
      j = m.actuator_trnid[u]
      jvadr = m.jnt_dofadr[j]
      radr = jvadr + 3 if m.jnt_type[j] == JointType.FREE else jvadr
      gvec = gear_all[u, :3]
      other_moments[u] = torch.cat([
          gvec.new_zeros(radr), gvec, gvec.new_zeros(m.nv - radr - 3)])
      length[u] = zero
      velocity[u] = torch.sum(gvec * d.qvel[..., radr:radr + 3], dim=-1)
    else:  # site transmission
      other_moments[u] = _site_moment(m, d, u)
      length[u] = velocity[u] = zero
  length = torch.stack(length, dim=-1)
  velocity = torch.stack(velocity, dim=-1)

  # activation dynamics
  if all(t == ActDyn.NONE for t in m.actuator_dyntype):
    inp = ctrl
    act_dot = torch.zeros_like(d.act)
  else:
    inputs = []
    act_dot = [d.act[..., a] * 0.0 for a in range(m.na)]
    dynprm = m.actuator_dynprm.to(dtype)
    for u in range(m.nu):
      dyn = m.actuator_dyntype[u]
      if dyn == ActDyn.NONE:
        inputs.append(ctrl[..., u])
      else:
        aadr = m.actuator_actadr[u]
        inputs.append(d.act[..., aadr])
        if dyn == ActDyn.INTEGRATOR:
          act_dot[aadr] = ctrl[..., u]
        else:  # FILTER / FILTEREXACT
          tau = torch.clamp(dynprm[u, 0], min=1e-8)
          act_dot[aadr] = (ctrl[..., u] - d.act[..., aadr]) / tau
    inp = torch.stack(inputs, dim=-1)
    act_dot = torch.stack(act_dot, dim=-1)

  gp, bp = m.actuator_gainprm.to(dtype), m.actuator_biasprm.to(dtype)
  gain = torch.where(
      _t(m, "gain_fixed", [t == GainBias.FIXED for t in m.actuator_gaintype]),
      gp[:, 0], gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity)
  bias = torch.where(
      _t(m, "bias_fixed", [t == GainBias.FIXED for t in m.actuator_biastype]),
      torch.zeros_like(length),
      bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity)
  force = gain * inp + bias
  frange = m.actuator_forcerange.to(dtype)
  force = torch.where(m.actuator_forcelimited,
                      math.clip(force, frange[:, 0], frange[:, 1]), force)

  qfrc = torch.zeros_like(d.qvel)
  if scalar_u:
    qfrc = qfrc.index_add(-1, vadr, gear * force[..., uidx])
  for u in other_u:
    qfrc = qfrc + other_moments[u] * force[..., u:u + 1]
  return d.replace(qfrc_actuator=qfrc, actuator_force=force,
                   act_dot=act_dot)
