"""Fingers: two planar fingers spin a free paddle to a target rate
(reference: mjpc/tasks/fingers).

Counterpart of mujoco_mpc_tpu/tasks/fingers.py ("Fingers") on
tasks/models/fingers.xml, the JAX package's MJCF. The spin goal is the task
parameter SpinGoal (Agent.set_task_parameter).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, registry

# residual_fingers in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 10
_REACH = 0.12  # the fingertips' distance to the paddle axis


def _planar_dist(a, b):
  dx, dy = a[0] - b[0], a[1] - b[1]
  return torch.sqrt(dx * dx + dy * dy)


def residual(model, data, params):
  """[spin - SpinGoal, the two fingertips' planar distances to the paddle
  less 0.12, ctrl] (7, B)."""
  spin = data.qvel[model.jnt_dofadr[model.joint("spin")]]
  paddle = data.xpos[model.body("spinner")]
  prox = torch.stack([
      _planar_dist(data.xpos[model.body(tip)], paddle) - _REACH
      for tip in ("f1_tip", "f2_tip")])
  return torch.cat([(spin - params[0])[None], prox, data.ctrl])


def build_fingers():
  """tasks/models/fingers.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "fingers.xml"))


@registry.register("Fingers", snapshot="fingers", builder=build_fingers)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "fingers", dtype, device)
  return base.Task(
      name="Fingers", model=model, spec=spec, params=params,
      residual=residual, param_names=pnames,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID,
          (model.jnt_dofadr[model.joint("spin")], model.body("spinner"),
           model.body("f1_tip"), model.body("f2_tip"))))
