"""Bimanual Insert and Bimanual Reorient on the two-arm ALOHA rig
(reference: mjpc/tasks/bimanual/insert/insert.cc, bimanual/reorient/).

Counterpart of mujoco_mpc_tpu/tasks/bimanual_insert.py, on the JAX
package's MJCF (tasks/models/bimanual_insert.xml with its connector
hulls under assets/connector/, and bimanual_reorient.xml).

Bimanual Insert: the left arm grasps the female connector, the right arm
the male one, both lift them to the target (mocap body 0) and mate them.
Its connectors are meshes (plane-mesh, box-mesh and mesh-mesh pairs),
outside the CUDA kernel's class: it has no CUDA residual and plans
through the general rollout. Residual layout (insert.cc:40-186), 45
entries: Reach L (3), Reach R (3) (each connector in its gripper site's
frame, y and z doubled), Grasp L (1), Grasp R (1) (0.5 (n_1 . n_2 + 1)
of the two fingers' mean contact normals on the connector, points within
2 cm of touching; 1 without contact on both fingers), Lift M (3), Lift F
(3) (connector - target, reordered z, x, y, x and y scaled by 0.1),
Insert (18) (the male site's six cross points against the female
site's), Velocity (16) (the arms' joint velocities). The transition
(insert.cc:189-229) puts the connectors back at their home pose once
mated (userdata[0] counts it, userdata[1] holds its time) and the whole
rig back at home 60 s after the last success.

Bimanual Reorient: the handover's arms turn a box in place to a goal
orientation (the goal pose is mocap body 0: its quaternion the
orientation, its position where the box stays). Residual layout, 28
entries: Reach L (3), Reach R (3) (the box in each gripper site's frame,
y and z doubled), Orientation (3) (the goal against the box,
sensors.quat_sub0), Position (3) (box - goal), Velocity (16) (the arms'
joint velocities).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import collision
from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, bimanual, registry

# residual_bimanual_reorient in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 17

_GOLDEN = 2.39996322972865332  # golden angle: the goal sequence
_REACHED = 0.25  # rotation-vector norm at which the goal advances

_RADIUS = 0.05  # the cross points' distance from a site (insert.cc:151)
_SOLVE_TIMEOUT = 60.0
_MATED = 0.01  # site distance at which the connectors count as mated


def _cross_points(pos, mat):
  """(18, B): the six points at +-_RADIUS along the site frame's axes
  (insert.cc:151-181), point-major; pos (3, B), mat (3, 3, B)."""
  pts = [pos + sgn * _RADIUS * mat[:, a] for sgn in (1.0, -1.0)
         for a in range(3)]
  return torch.cat(pts)


def _grasp(model, data, side, obj):
  """One hand's grasp term on the object geom `obj`."""
  normals = []
  for finger in (f"{side}/fingerL_geom", f"{side}/fingerR_geom"):
    slot = collision.geom_pair_slots(model, model.geom(finger),
                                     model.geom(obj))
    normals.append(bimanual._finger_normal(data.contact, slot))
  (n1, h1), (n2, h2) = normals
  return torch.where(h1 & h2, 0.5 * (sensors.dot0(n1, n2) + 1.0),
                     torch.ones_like(n1[0]))


def insert_residual(model, data, params):
  """Residual (45, B) on the component-leading, batch-trailing view of the
  general rollout's Data."""
  female = data.xpos[model.body("female")]
  male = data.xpos[model.body("male")]
  target = data.mocap_pos[0]
  xy_scale = base.const_column(model, "insert_xy_scale", [1.0, 0.1, 0.1],
                               male)
  f_site, m_site = model.site("female_site"), model.site("male_site")
  return torch.cat([
      bimanual._gripper_frame_vec(model, data, "left/gripper", female),
      bimanual._gripper_frame_vec(model, data, "right/gripper", male),
      _grasp(model, data, "left", "female_geom")[None],
      _grasp(model, data, "right", "male_geom")[None],
      (male - target)[[2, 0, 1]] * xy_scale,
      (female - target)[[2, 0, 1]] * xy_scale,
      _cross_points(data.site_xpos[m_site], data.site_xmat[m_site]) -
      _cross_points(data.site_xpos[f_site], data.site_xmat[f_site]),
      data.qvel[:16],
  ])


def insert_transition(model, data, params):
  """Success puts the connectors (qpos 16:30, qvel 16:28) back at the
  home keyframe at rest; 60 s after the last success the whole rig goes
  back to the keyframe (insert.cc:189-229, as the JAX package has it:
  the keyframe's connector poses written at qpos 12:26, qvel 12:24)."""
  f_site, m_site = model.site("female_site"), model.site("male_site")
  err = torch.linalg.vector_norm(
      data.site_xpos[m_site] - data.site_xpos[f_site], dim=0)
  solved = (data.time > 0) & (err < _MATED)
  key_qpos = base.const_column(model, "home_qpos",
                              model.keyframe("home")[0], data.qpos)
  qpos, qvel, u = data.qpos, data.qvel, data.userdata
  conn_q = torch.where(solved, key_qpos[16:30], qpos[16:30])
  qpos = torch.cat([qpos[:12], conn_q, qpos[26:]])
  conn_v = torch.where(solved, torch.zeros_like(qvel[16:28]), qvel[16:28])
  qvel = torch.cat([qvel[:12], conn_v, qvel[24:]])
  solve_time = torch.where(solved, data.time, u[1])
  stuck = data.time > solve_time + _SOLVE_TIMEOUT
  qpos = torch.where(stuck, key_qpos, qpos)
  qvel = torch.where(stuck, torch.zeros_like(qvel), qvel)
  solve_time = torch.where(stuck, data.time, solve_time)
  count = u[0] + torch.where(solved, 1.0, 0.0).to(u.dtype)
  return data.replace(qpos=qpos, qvel=qvel, userdata=torch.cat(
      [count[None], solve_time[None].to(u.dtype), u[2:]]))


def build_insert():
  """tasks/models/bimanual_insert.xml as a mujoco.MjModel (needs
  mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models",
                   "bimanual_insert.xml"))


@registry.register("Bimanual Insert", snapshot="bimanual_insert",
                   builder=build_insert)
def make_insert(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "bimanual_insert", dtype, device)
  return base.Task(name="Bimanual Insert", model=model, spec=spec,
                   params=params, residual=insert_residual,
                   param_names=pnames, transition=insert_transition)


def reorient_residual(model, data, params):
  """Residual (28, B) on the component-leading, batch-trailing view."""
  box_body = model.body("box")
  box = data.xpos[box_body]
  goal = data.mocap_quat[0]
  goal = goal / sensors.norm0(goal)
  return torch.cat([
      bimanual._gripper_frame_vec(model, data, "left/gripper", box),
      bimanual._gripper_frame_vec(model, data, "right/gripper", box),
      sensors.quat_sub0(goal, data.xquat[box_body]),
      box - data.mocap_pos[0],
      data.qvel[:16],
  ])


def reorient_transition(model, data, params):
  """The goal advance of the JAX package: once the box is within
  _REACHED of the goal orientation (the norm of mju_subQuat's rotation
  vector), the goal moves to the next of a golden-angle sequence about a
  wandering axis; userdata[0] counts the goals reached."""
  box_quat = data.xquat[model.body("box")]
  goal = data.mocap_quat[0]
  goal = goal / torch.linalg.vector_norm(goal, dim=0)
  err = pmath.quat_sub(torch.movedim(goal, 0, -1),
                       torch.movedim(box_quat, 0, -1))
  reached = torch.linalg.vector_norm(err, dim=-1) < _REACHED
  idx = data.userdata[0] + torch.where(reached, 1.0, 0.0)
  ang = _GOLDEN * idx
  raw = torch.stack([torch.sin(1.7 * idx), torch.cos(2.3 * idx),
                     torch.sin(0.9 * idx + 1.0)])
  axis = raw / torch.clamp(torch.linalg.vector_norm(raw, dim=0), min=1e-9)
  new_goal = torch.cat([torch.cos(ang / 2)[None], torch.sin(ang / 2) * axis])
  goal2 = torch.where(reached, new_goal.to(goal.dtype), goal)
  return data.replace(
      mocap_quat=torch.cat([goal2[None], data.mocap_quat[1:]]),
      userdata=torch.cat([idx[None].to(data.userdata.dtype),
                          data.userdata[1:]]))


def _device_residual(model) -> base.DeviceResidual:
  """residual_bimanual_reorient's operands: the box body and the two
  gripper sites with their orientations."""
  spos = model.site_pos.detach().cpu().numpy()
  squat = model.site_quat.detach().cpu().numpy()
  sites = tuple((model.site_bodyid[s], tuple(float(x) for x in spos[s]),
                 tuple(float(x) for x in squat[s]))
                for s in (model.site(n) for n in bimanual._SITES))
  return base.DeviceResidual(DEVICE_RESIDUAL_ID, (model.body("box"),),
                             (), sites)


def build_reorient():
  """tasks/models/bimanual_reorient.xml as a mujoco.MjModel (needs
  mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models",
                   "bimanual_reorient.xml"))


@registry.register("Bimanual Reorient", snapshot="bimanual_reorient",
                   builder=build_reorient)
def make_reorient(dtype=torch.float32,
                  device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "bimanual_reorient", dtype, device)
  return base.Task(name="Bimanual Reorient", model=model, spec=spec,
                   params=params, residual=reorient_residual,
                   param_names=pnames, transition=reorient_transition,
                   device_residual=_device_residual(model))
