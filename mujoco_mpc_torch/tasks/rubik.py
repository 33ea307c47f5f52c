"""Rubik Faces: the cube's six face layers as directly actuated hinges
(reference: mjpc/tasks/rubik's transition model).

Counterpart of mujoco_mpc_tpu/tasks/rubik.py:181-241 ("Rubik Faces") on
tasks/models/rubik.xml, the JAX package's MJCF: no contacts and no limits,
so no constraint rows at all. The face targets are userdata[2:8];
userdata[0] and [1] are the scramble/solve FSM's mode and move index. The
FSM (the JAX transition) waits for the general engine and Agent.step
(ROADMAP queue 1 item 5); until then callers set the targets through
Agent.set_state(userdata=faces_userdata(...)). "Rubik", the hand holding
the cube, is outside the kernel's class (nv 36).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, registry

# residual_rubik_faces in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 13
_TARGETS = slice(2, 8)


def faces_userdata(n: int, targets, mode: float = 0.0,
                   index: float = 0.0) -> np.ndarray:
  """userdata (n,) holding the FSM's mode and move index and the six face
  targets."""
  ud = np.zeros(n, np.float32)
  ud[0], ud[1] = mode, index
  ud[_TARGETS] = targets
  return ud


def residual(model, data, params):
  """[qpos[:6] - targets, qvel[:6], ctrl] (18, B)."""
  return torch.cat([data.qpos[:6] - data.userdata[_TARGETS],
                    data.qvel[:6], data.ctrl])


def build_rubik_faces():
  """tasks/models/rubik.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "rubik.xml"))


@registry.register("Rubik Faces", snapshot="rubik_faces",
                   builder=build_rubik_faces)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "rubik_faces", dtype, device)
  return base.Task(name="Rubik Faces", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   device_residual=base.DeviceResidual(DEVICE_RESIDUAL_ID))
