"""Quadrotor: fly to a goal point and hover (reference:
mjpc/tasks/quadrotor).

Counterpart of mujoco_mpc_tpu/tasks/quadrotor.py ("Quadrotor") on
tasks/models/quadrotor.xml, the JAX package's MJCF: four thrusters on
site transmissions, which the CUDA kernel's class does not hold, so the
task plans through the general rollout.

Residual layout, 10 + nu entries: Position (3) (the core less the goal,
residual_Goal*), Upright (1), Linear velocity (3) (the core's centre of
mass), Angular velocity (3), Control (nu) (thrust less hover).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, registry

_HOVER_THRUST = 1.962  # total mass 0.8 kg times g over 4 rotors


def residual(model, data, params):
  """Residual (14, B) on the component-leading, batch-trailing view."""
  core = model.body("core")
  cvel = data.cvel[core]
  goal = params[:3].reshape((3,) + (1,) * (data.qpos.dim() - 1))
  return torch.cat([
      data.xpos[core] - goal,
      (data.xmat[core, 2, 2] - 1.0)[None],
      cvel[3:] + sensors.cross0(cvel[:3], data.xipos[core]),
      cvel[:3],
      data.ctrl - _HOVER_THRUST,
  ])


def build_quadrotor():
  """tasks/models/quadrotor.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "quadrotor.xml"))


@registry.register("Quadrotor", snapshot="quadrotor",
                   builder=build_quadrotor)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("quadrotor", dtype,
                                                         device)
  return base.Task(name="Quadrotor", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames)
