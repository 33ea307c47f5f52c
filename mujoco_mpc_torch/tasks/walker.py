"""Planar walker: walk forward at target speed staying tall and upright
(reference: mjpc/tasks/walker)."""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_walker in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 1


def residual(model, data, params):
  """Residual (9, *b); `data` fields are component-leading, batch-trailing
  (the tile view of physics/tilestep.py::step_tb)."""
  speed_goal = params[0]
  height_goal = params[1]
  torso = model.body("torso")
  height = data.xpos[torso, 2]
  # torso z-axis in world: upright when pointing up
  upright = data.xmat[torso, 2, 2]
  # forward (x) root velocity; dm_control orders the root joints
  # rootz/rootx/rooty
  vx = data.qvel[model.jnt_dofadr[model.joint("rootx")]]
  return torch.cat([
      (height - height_goal)[None],
      (upright - 1.0)[None],
      (vx - speed_goal)[None],
      data.ctrl[:6],
  ])


@registry.register("Walker", snapshot="walker",
                   builder=dm_suite.build_walker)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "walker", dtype, device)
  return base.Task(
      name="Walker", model=model, spec=spec, params=params,
      residual=residual, param_names=pnames,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID,
          (model.body("torso"), model.jnt_dofadr[model.joint("rootx")])))
