"""Cartpole swing-up (reference: mjpc/tasks/cartpole/cartpole.cc:36-50).

Counterpart of mujoco_mpc_tpu/tasks/cartpole.py ("Cartpole") on the
dm_control cartpole (dm_suite.build_cartpole). Its MJCF names the gradient
planner (`agent_planner` 1), which Agent("Cartpole") plans with;
Agent("Cartpole", planner="sampling") takes the model's sampling_*
settings and plans through the kernel.
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_cartpole in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 7


def residual(model, data, params):
  """[cos(pole) - 1, cart - goal, pole velocity, control] (4, B); the goal
  is residual_Goal, 0 where the task has none."""
  goal = params[0] if params.shape[0] else 0.0
  return torch.stack([
      torch.cos(data.qpos[1]) - 1.0,
      data.qpos[0] - goal,
      data.qvel[1],
      data.ctrl[0],
  ])


@registry.register("Cartpole", snapshot="cartpole",
                   builder=dm_suite.build_cartpole)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "cartpole", dtype, device)
  return base.Task(name="Cartpole", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   device_residual=base.DeviceResidual(DEVICE_RESIDUAL_ID))
