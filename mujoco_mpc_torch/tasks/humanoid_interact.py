"""Humanoid Interact: the humanoid sits on a chair, or stands (reference:
mjpc/tasks/humanoid/interact/interact.cc:30-196).

Counterpart of mujoco_mpc_tpu/tasks/humanoid_interact.py ("Humanoid
Interact") on dm_suite.build_humanoid_interact (the humanoid plant and a
chair). userdata[MODE_SLOT] picks the mode, Sit (0) or Stand (1),
truncated as astype(int32) does; `weight_mod` turns the seat term on and
the feet-placement terms off in Sit, and the other way in Stand.

Residual layout, 13 + nu entries: Torso Up, Pelvis Up (0 in Sit),
RFoot Up, LFoot Up (each |z_zz - 1|), Head Height (|head z - the mode's
height|, residual_SitHeadHeight or residual_StandHeadHeight), Knee Feet XY,
COM Feet XY (planar distances to the feet's centre), Facing Dir (the
torso's planar heading against the direction to the chair), CoM Vel (2),
Pelvis Seat (3) (pelvis - seat site - 0.08 z), Control (nu) (ctrl less
the home keyframe's). The JAX residual is written for one state (its
pelvis-seat offset does not broadcast on a batch); this is its meaning for
each candidate.
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_humanoid_interact in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 18

MODE_SIT, MODE_STAND = 0, 1
MODE_NAMES = ("Sit", "Stand")
_T_KNEE_XY, _T_COM_XY, _T_SEAT = 5, 6, 9
_NTERM = 11


def _norm2(x):
  """The norm of a planar vector (2, ...)."""
  return torch.sqrt(x[0] * x[0] + x[1] * x[1])


def _up(model, data, body):
  return torch.abs(data.xmat[model.body(body), 2, 2] - 1.0)


def residual(model, data, params):
  """Residual (34, B) on the component-leading, batch-trailing view."""
  sit = data.userdata[base.MODE_SLOT].to(torch.int32) == MODE_SIT
  torso, pelvis = model.body("torso"), model.body("pelvis")
  rfoot, lfoot = model.body("right_foot"), model.body("left_foot")
  up_pelvis = torch.where(sit, 0.0, _up(model, data, "pelvis"))
  head = data.site_xpos[model.site("head_site")]
  head_height = torch.abs(head[2] - torch.where(sit, params[0], params[1]))
  knees = 0.5 * (data.xpos[model.body("right_shin")][:2]
                 + data.xpos[model.body("left_shin")][:2])
  feet = 0.5 * (data.xpos[rfoot][:2] + data.xpos[lfoot][:2])
  com = data.subtree_com[torso]
  fwd = data.xmat[torso, :2, 0]
  fwd = fwd / torch.clamp(_norm2(fwd), min=1e-9)
  to_chair = data.xpos[model.body("chair")][:2] - data.xpos[torso][:2]
  to_chair = to_chair / torch.clamp(_norm2(to_chair), min=1e-9)
  seat = data.site_xpos[model.site("seat_site")]
  offset = base.const_column(model, "interact_seat", (0.0, 0.0, 0.08),
                             seat)
  home = base.const_column(model, "interact_home_ctrl",
                           base.home_ctrl(model), data.ctrl)
  scalars = [_up(model, data, "torso"), up_pelvis,
             _up(model, data, "right_foot"), _up(model, data, "left_foot"),
             head_height, _norm2(knees - feet), _norm2(com[:2] - feet),
             _norm2(fwd - to_chair)]
  return torch.cat([
      torch.stack(torch.broadcast_tensors(*scalars)),
      sensors.subtree_linvel(model, data, torso)[:2],
      data.xpos[pelvis] - seat - offset,
      data.ctrl - home,
  ])


def weight_mod(model, data, params):
  """Sit: the seat term on, Knee Feet XY and COM Feet XY off; Stand the
  other way; a (11, ...) multiplier."""
  sit = (data.userdata[base.MODE_SLOT].to(torch.int32) == MODE_SIT).to(
      data.userdata.dtype)
  rows = [sit * 0.0 + 1.0] * _NTERM
  rows[_T_SEAT] = sit
  rows[_T_KNEE_XY] = 1.0 - sit
  rows[_T_COM_XY] = 1.0 - sit
  return torch.stack(rows)


def _device_residual(model) -> base.DeviceResidual:
  """residual_humanoid_interact's operands: the torso, pelvis, feet,
  shins and chair, the torso's descendant set as a body bitmask; its
  subtree mass, the home ctrl; the head and seat sites."""
  torso = model.body("torso")
  mask = sum(1 << b for b in sensors._descendants(model, torso))
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (torso, model.body("pelvis"), model.body("right_foot"),
       model.body("left_foot"), model.body("right_shin"),
       model.body("left_shin"), model.body("chair"), mask),
      (float(model.body_subtreemass[torso]),) + base.home_ctrl(model),
      (base.site_ref(model, "head_site"), base.site_ref(model, "seat_site")))


@registry.register("Humanoid Interact", snapshot="humanoid_interact",
                   builder=dm_suite.build_humanoid_interact)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "humanoid_interact", dtype, device)
  return base.Task(name="Humanoid Interact", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   weight_mod=weight_mod, mode_names=MODE_NAMES,
                   device_residual=_device_residual(model))
