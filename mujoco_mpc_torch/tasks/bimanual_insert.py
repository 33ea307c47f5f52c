"""Bimanual Reorient: the two-arm rig turns a box in place to a goal
orientation (reference: mjpc/tasks/bimanual/reorient/).

Counterpart of mujoco_mpc_tpu/tasks/bimanual_insert.py:119-155 ("Bimanual
Reorient") on tasks/models/bimanual_reorient.xml, the JAX package's MJCF:
the handover's two arms and a free box; the goal pose is mocap body 0 (its
quaternion the orientation, its position where the box stays). The Insert
half of that module waits for the plane-mesh pair (ROADMAP queue 1 items 4
and 11c).

Residual layout, 28 entries: Reach L (3), Reach R (3) (the box in each
gripper site's frame, y and z doubled), Orientation (3) (the goal against
the box, sensors.quat_sub0), Position (3) (box - goal), Velocity (16) (the
arms' joint velocities).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, bimanual, registry

# residual_bimanual_reorient in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 17

_GOLDEN = 2.39996322972865332  # golden angle: the goal sequence
_REACHED = 0.25  # rotation-vector norm at which the goal advances


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
