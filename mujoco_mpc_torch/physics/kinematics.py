"""Forward kinematics: qpos to world frames of bodies, joints, geoms and
sites.

Counterpart of mujoco_mpc_tpu/physics/kinematics.py (MuJoCo's
mj_kinematics: joint displacements relative to qpos0). The body loop is
unrolled over the static tree; the batch rides the leading dimensions.
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch.physics import math
from mujoco_mpc_torch.physics.types import Data, JointType, Model


def _index(m: Model, name: str, values) -> torch.Tensor:
  return m.const(("index", name), lambda: torch.as_tensor(
      list(values), dtype=torch.long, device=m.device))


def kinematics(m: Model, d: Data) -> Data:
  qpos = d.qpos
  batch = qpos.shape[:-1]
  dtype = qpos.dtype
  world_pos = qpos.new_zeros(batch + (3,))
  world_quat = torch.cat([qpos.new_ones(batch + (1,)),
                          qpos.new_zeros(batch + (3,))], dim=-1)
  xpos, xquat = [world_pos], [world_quat]
  xanchor = [None] * m.njnt
  xaxis = [None] * m.njnt
  body_pos, body_quat = m.body_pos.to(dtype), m.body_quat.to(dtype)
  jnt_pos, jnt_axis = m.jnt_pos.to(dtype), m.jnt_axis.to(dtype)
  qpos0 = m.qpos0.to(dtype)

  for b in range(1, m.nbody):
    p = m.body_parentid[b]
    quat = math.quat_mul(xquat[p], body_quat[b])
    pos = xpos[p] + math.quat_rot(xquat[p], body_pos[b])
    mid = m.body_mocapid[b]
    if mid >= 0:
      pos = d.mocap_pos[..., mid, :]
      quat = d.mocap_quat[..., mid, :]
    jadr, jnum = m.body_jntadr[b], m.body_jntnum[b]
    for j in range(jadr, jadr + jnum):
      qadr = m.jnt_qposadr[j]
      jtype = m.jnt_type[j]
      if jtype == JointType.FREE:
        pos = qpos[..., qadr:qadr + 3]
        quat = qpos[..., qadr + 3:qadr + 7]
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
        xanchor[j] = pos
        xaxis[j] = math.quat_rot(quat, jnt_axis[j])
        continue
      anchor = pos + math.quat_rot(quat, jnt_pos[j])
      if jtype == JointType.BALL:
        qloc = qpos[..., qadr:qadr + 4]
        qloc = qloc / torch.linalg.vector_norm(qloc, dim=-1, keepdim=True)
        quat = math.quat_mul(quat, qloc)
        pos = anchor - math.quat_rot(quat, jnt_pos[j])
      elif jtype == JointType.SLIDE:
        pos = pos + math.quat_rot(quat, jnt_axis[j]) * (
            qpos[..., qadr:qadr + 1] - qpos0[qadr])
      elif jtype == JointType.HINGE:
        angle = qpos[..., qadr] - qpos0[qadr]
        quat = math.quat_mul(quat, math.axis_angle_quat(jnt_axis[j], angle))
        pos = anchor - math.quat_rot(quat, jnt_pos[j])
      xanchor[j] = anchor
      xaxis[j] = math.quat_rot(quat, jnt_axis[j])
    xpos.append(pos.expand(batch + (3,)))
    xquat.append(quat.expand(batch + (4,)))

  xpos = torch.stack(xpos, dim=-2)
  xquat = torch.stack(xquat, dim=-2)
  xmat = math.quat_to_mat(xquat)
  if m.njnt:
    xanchor = torch.stack([a.expand(batch + (3,)) for a in xanchor], dim=-2)
    xaxis = torch.stack([a.expand(batch + (3,)) for a in xaxis], dim=-2)
  else:
    xanchor = qpos.new_zeros(batch + (0, 3))
    xaxis = qpos.new_zeros(batch + (0, 3))

  # inertial, geom and site frames: the body's frame times each one's
  # fixed local frame (R(q1 q2) = R(q1) R(q2), as products of matrices)
  def frame(body_xmat, body_xpos, local_pos, local_quat, key):
    rot = m.const(("local_mat", key, dtype),
                  lambda: math.quat_to_mat(local_quat.to(dtype)))
    return (body_xpos + math.mat_vec(body_xmat, local_pos.to(dtype)),
            body_xmat @ rot)

  xipos, ximat = frame(xmat, xpos, m.body_ipos, m.body_iquat, "body_i")
  gb = _index(m, "geom_bodyid", m.geom_bodyid)
  geom_xpos, geom_xmat = frame(xmat[..., gb, :, :], xpos[..., gb, :],
                               m.geom_pos, m.geom_quat, "geom")
  sb = _index(m, "site_bodyid", m.site_bodyid)
  site_xpos, site_xmat = frame(xmat[..., sb, :, :], xpos[..., sb, :],
                               m.site_pos, m.site_quat, "site")

  # subtree centres of mass: one ancestor-mask product
  anc = m.const(("anc", dtype), lambda: m.body_ancestor_mask.to(dtype))
  mass = m.body_mass.to(dtype)
  mass_moment = anc @ (mass[:, None] * xipos)
  mass_total = anc @ mass
  subtree_com = mass_moment / torch.clamp(mass_total, min=1e-12)[:, None]

  return d.replace(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos, geom_xmat=geom_xmat,
      site_xpos=site_xpos, site_xmat=site_xmat, subtree_com=subtree_com)
