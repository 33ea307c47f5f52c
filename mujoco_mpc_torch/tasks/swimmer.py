"""Swimmer: reach a target by undulating in a viscous fluid (reference:
mjpc/tasks/swimmer).

Counterpart of mujoco_mpc_tpu/tasks/swimmer.py ("Swimmer") on
dm_suite.build_swimmer: fluid forces and filter actuators, outside the
CUDA kernel's class, so the task plans through the general rollout. The
target is mocap body 0; `transition` moves it on once the nose reaches it.

Residual layout, 3 + nu entries: Distance (2) (nose - target, planar),
MoveToward (1) (the nose's planar speed toward the target less 0.2),
Control (nu).
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, dm_suite, registry

_GOLDEN = 2.39996  # radians: the target sequence


def residual(model, data, params):
  """Residual (8, B) on the component-leading, batch-trailing view."""
  nose = data.site_xpos[model.site("nose")]
  delta = nose[:2] - data.mocap_pos[0][:2]
  cvel = data.cvel[model.body("head")]
  v = cvel[3:] + sensors.cross0(cvel[:3], nose)
  dist = torch.sqrt(delta[0] * delta[0] + delta[1] * delta[1])
  direction = -delta / torch.clamp(dist, min=1e-6)
  toward = v[0] * direction[0] + v[1] * direction[1] - 0.2
  return torch.cat([delta, toward[None], data.ctrl])


def transition(model, data, params):
  """Once the nose is within 6 cm of the target, the target moves 0.5 m
  from the nose along a golden-angle sequence; userdata[0] counts the
  targets reached."""
  nose = data.site_xpos[model.site("nose")][:2]
  mp = data.mocap_pos
  target = mp[0][:2]
  reached = torch.linalg.vector_norm(nose - target, dim=0) < 0.06
  idx = data.userdata[0] + torch.where(reached, 1.0, 0.0)
  ang = _GOLDEN * idx
  new_target = nose + 0.5 * torch.stack([torch.cos(ang), torch.sin(ang)])
  target2 = torch.where(reached, new_target, target).to(mp.dtype)
  goal = torch.cat([target2, mp[0][2:].expand((1,) + target2.shape[1:])])
  return data.replace(
      mocap_pos=torch.cat([goal[None], mp[1:]]),
      userdata=torch.cat([idx[None].to(data.userdata.dtype),
                          data.userdata[1:]]))


@registry.register("Swimmer", snapshot="swimmer",
                   builder=dm_suite.build_swimmer)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("swimmer", dtype,
                                                         device)
  return base.Task(name="Swimmer", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   transition=transition)
