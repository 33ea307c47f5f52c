"""OP3: a small biped stands, or stands on its hands (reference:
mjpc/tasks/op3/stand.cc:26-130).

Counterpart of mujoco_mpc_tpu/tasks/op3.py ("OP3") on tasks/models/op3.xml,
the JAX package's MJCF. userdata[MODE_SLOT] picks the mode, Stand (0) or
Handstand (1), truncated to an integer as astype(int32) does.

Residual layout, 4 + nu + 7 + (nv - 6) entries:
  Height (1): head over feet (Stand) or feet over hands (Handstand) less
    the goal, residual_Height;
  Balance (1): the planar distance of the torso subtree's centre of mass
    from the support (feet, or hands);
  CoM Vel (2): the subtree's planar velocity;
  Ctrl Diff (nu): ctrl less the home keyframe's;
  Upright (7): the torso's z axis (z up, or down), both feet's z axes;
  Joint Vel (nv - 6).
The JAX residual is written for one state (its Balance norm runs over
every axis, its home ctrl does not broadcast on a batch); this is its
meaning for each candidate.
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, registry

# residual_op3 in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 14

MODE_STAND, MODE_HANDSTAND = 0, 1
MODE_NAMES = ("Stand", "Handstand")


def residual(model, data, params):
  """Residual (35, B) on the component-leading, batch-trailing view."""
  mode = data.userdata[base.MODE_SLOT].to(torch.int32)
  hand = mode == MODE_HANDSTAND
  torso = model.body("torso")
  rfoot, lfoot = model.body("right_foot"), model.body("left_foot")
  feet = 0.5 * (data.xpos[rfoot] + data.xpos[lfoot])
  head = data.site_xpos[model.site("head")]
  hands = 0.5 * (data.xpos[model.body("right_hand")]
                 + data.xpos[model.body("left_hand")])
  height = torch.where(hand, feet[2] - hands[2] - params[0],
                       head[2] - feet[2] - params[0])
  com = data.subtree_com[torso]
  d = com[:2] - torch.where(hand, hands[:2], feet[:2])
  balance = torch.sqrt(d[0] * d[0] + d[1] * d[1])
  comvel = sensors.subtree_linvel(model, data, torso)[:2]
  home = base.const_column(model, "op3_home_ctrl", base.home_ctrl(model),
                           data.ctrl)
  sign = torch.where(hand, -1.0, 1.0).to(data.qpos.dtype)
  up = [data.xmat[torso, 2, 2] - sign]
  for foot in (rfoot, lfoot):
    z = data.xmat[foot, :, 2]
    up += [z[0], z[1], z[2] - sign]
  return torch.cat([
      height[None], balance[None], comvel, data.ctrl - home,
      torch.stack(torch.broadcast_tensors(*up)), data.qvel[6:],
  ])


def _device_residual(model) -> base.DeviceResidual:
  """residual_op3's operands: the torso, feet and hands, the torso's
  descendant set as a body bitmask; its subtree mass, the home ctrl; the
  head site."""
  torso = model.body("torso")
  mask = sum(1 << b for b in sensors._descendants(model, torso))
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (torso, model.body("right_foot"), model.body("left_foot"),
       model.body("right_hand"), model.body("left_hand"), mask),
      (float(model.body_subtreemass[torso]),) + base.home_ctrl(model),
      (base.site_ref(model, "head"),))


def build_op3():
  """tasks/models/op3.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "op3.xml"))


@registry.register("OP3", snapshot="op3", builder=build_op3)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("op3", dtype,
                                                         device)
  return base.Task(name="OP3", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   mode_names=MODE_NAMES,
                   device_residual=_device_residual(model))
