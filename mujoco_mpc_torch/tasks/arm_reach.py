"""7-dof arm end-effector reach (reference: mjpc/tasks/panda).

Counterpart of mujoco_mpc_tpu/tasks/arm_reach.py ("Arm Reach") on
tasks/models/arm_reach.xml, the JAX package's MJCF: no contacts, 14
joint-limit rows. The goal is mocap body 0 (Agent.set_state(mocap_pos=…)).
"""

from __future__ import annotations

import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, registry

# residual_arm_reach in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 11


def home_offset(model, ctrl):
  """ctrl less the home keyframe's ctrl (nu, B)."""
  home = torch.tensor(base.home_ctrl(model), dtype=ctrl.dtype,
                      device=ctrl.device)
  return ctrl - home[:, None]


def residual(model, data, params):
  """[ee - goal (3), qvel (7), ctrl - home ctrl (7)] (17, B)."""
  ee = data.site_xpos[model.site("ee")]
  return torch.cat([ee - data.mocap_pos[0], data.qvel,
                    home_offset(model, data.ctrl)])


def build_arm_reach():
  """tasks/models/arm_reach.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "arm_reach.xml"))


@registry.register("Arm Reach", snapshot="arm_reach",
                   builder=build_arm_reach)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "arm_reach", dtype, device)
  return base.Task(
      name="Arm Reach", model=model, spec=spec, params=params,
      residual=residual, param_names=pnames,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID, floats=base.home_ctrl(model),
          sites=(base.site_ref(model, "ee"),)))
