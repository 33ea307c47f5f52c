"""Push: an arm pushes a free box to a target on the table (reference:
mjpc/tasks/manipulation).

Counterpart of mujoco_mpc_tpu/tasks/push.py ("Push") on
tasks/models/push.xml, the JAX package's MJCF. The target is mocap body 0
(Agent.set_state(mocap_pos=…)).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import arm_reach, base, registry

# residual_push in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 12


def residual(model, data, params):
  """[box - target (x, y), ee - box (3), qvel[:4], ctrl - home ctrl (4)]
  (13, B)."""
  ee = data.site_xpos[model.site("ee")]
  box = data.xpos[model.body("box")]
  return torch.cat([box[:2] - data.mocap_pos[0][:2], ee - box,
                    data.qvel[:4], arm_reach.home_offset(model, data.ctrl)])


def build_push():
  """tasks/models/push.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "push.xml"))


@registry.register("Push", snapshot="push", builder=build_push)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("push", dtype,
                                                         device)
  return base.Task(
      name="Push", model=model, spec=spec, params=params, residual=residual,
      param_names=pnames,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID, (model.body("box"),), base.home_ctrl(model),
          (base.site_ref(model, "ee"),)))
