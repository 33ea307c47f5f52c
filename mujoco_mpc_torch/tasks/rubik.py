"""Rubik Faces: the cube's six face layers as directly actuated hinges
(reference: mjpc/tasks/rubik's transition model).

Counterpart of mujoco_mpc_tpu/tasks/rubik.py:181-241 ("Rubik Faces") on
tasks/models/rubik.xml, the JAX package's MJCF: no contacts and no limits,
so no constraint rows at all. The face targets are userdata[2:8];
userdata[0] and [1] are the scramble/solve FSM's mode and move index,
which `transition` advances when every face has settled on its target
(faces_userdata sets a start). "Rubik", the hand holding the cube, is not
ported yet (nv 36, outside the kernel's class).
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
_HALF_PI = 1.5707963267948966
MODE_SCRAMBLE, MODE_SOLVE, MODE_WAIT = 0, 1, 2


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


def _faces_move(k):
  """(face, direction) of move k of the scramble sequence."""
  return (torch.remainder(3.0 * k + 1.0, 6.0),
          1.0 - 2.0 * torch.remainder(k, 2.0))


def transition(model, data, params):
  """Advance the scramble (or undo it, in solve mode) by one move once
  every face is within params[1] of its target and turning slower than
  0.6; after params[0] moves scrambled, solve; solved, wait."""
  n_moves, tol = params[0], params[1]
  ud = data.userdata
  mode, idx, targets = ud[0], ud[1], ud[_TARGETS]
  settled = ((torch.amax(torch.abs(data.qpos[:6] - targets), dim=0) < tol) &
             (torch.amax(torch.abs(data.qvel[:6]), dim=0) < 0.6))
  faces = torch.arange(6, dtype=targets.dtype, device=targets.device)
  faces = faces.reshape((6,) + (1,) * (targets.dim() - 1))
  face_s, dir_s = _faces_move(idx)
  scramble = targets + torch.where(faces == face_s, dir_s * _HALF_PI, 0.0)
  face_u, dir_u = _faces_move(idx - 1.0)
  solve = targets - torch.where(faces == face_u, dir_u * _HALF_PI, 0.0)
  in_scramble = (mode == MODE_SCRAMBLE) & settled
  in_solve = (mode == MODE_SOLVE) & settled
  new_targets = torch.where(in_scramble, scramble,
                            torch.where(in_solve, solve, targets))
  new_idx = torch.where(in_scramble, idx + 1.0,
                        torch.where(in_solve, idx - 1.0, idx))
  to_solve = in_scramble & (idx + 1.0 >= n_moves)
  to_wait = in_solve & (idx - 1.0 <= 0.0)
  new_mode = torch.where(to_solve, float(MODE_SOLVE),
                         torch.where(to_wait, float(MODE_WAIT), mode))
  out = torch.cat([new_mode[None], new_idx[None], new_targets, ud[8:]])
  return data.replace(userdata=out.to(ud.dtype))


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
                   transition=transition,
                   device_residual=base.DeviceResidual(DEVICE_RESIDUAL_ID))
