"""Rubik and Rubik Faces, with the JAX package's names: `make`,
`residual` and `transition` are the hand's, `make_faces` builds the bare
face mechanism.

"Rubik Faces" (mujoco_mpc_tpu/tasks/rubik.py:181-241; the reference's
mjpc/tasks/rubik transition model) is the cube's six face layers as
directly actuated hinges on tasks/models/rubik.xml, the JAX package's
MJCF: no contacts and no limits, so no constraint rows at all. The face
targets are userdata[2:8]; userdata[0] and [1] are the scramble/solve
FSM's mode and move index, which `_faces_transition` advances when every
face has settled on its target (faces_userdata sets a start).

"Rubik" (mujoco_mpc_tpu/tasks/rubik.py:1-173, the reference's
rubik/solve.cc:1-248) is the Shadow hand holding a free cube with six
passive face hinges, on tasks/models/rubik_hand.xml: nv 36, 74 contact
points and 344 constraint rows, beyond the CUDA kernel's maxima, so it
plans through the general rollout. userdata[0] holds the FSM's mode and
userdata[1] the goal stage g; the face targets at stage g are the sum of
the moves k < g of a fixed invertible sequence. Its residual, 84 entries:
In Hand (3) (cube - grasp site), Orientation (3) (the goal, mocap body 0,
against the cube, sensors.quat_sub0), Cube Vel. (3), Actuator (20) (the
actuator forces), six face errors (in solve mode, else 0), Grasp (24) (the
hand's angles less home), Joint Vel. (24), Remaining (1) (12 g).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
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


def _faces_residual(model, data, params):
  """Residual (18, B) of "Rubik Faces": [qpos[:6] - targets, qvel[:6],
  ctrl]."""
  return torch.cat([data.qpos[:6] - data.userdata[_TARGETS],
                    data.qvel[:6], data.ctrl])


def _faces_move(k):
  """(face, direction) of move k of the scramble sequence."""
  return (torch.remainder(3.0 * k + 1.0, 6.0),
          1.0 - 2.0 * torch.remainder(k, 2.0))


def _faces_transition(model, data, params):
  """Rubik Faces' FSM: advance the scramble (or undo it, in solve mode)
  by one move once every face is within params[1] of its target and
  turning slower than 0.6; after params[0] moves scrambled, solve;
  solved, wait."""
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
def make_faces(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "rubik_faces", dtype, device)
  return base.Task(name="Rubik Faces", model=model, spec=spec,
                   params=params, residual=_faces_residual,
                   param_names=pnames, transition=_faces_transition,
                   device_residual=base.DeviceResidual(DEVICE_RESIDUAL_ID))


# the full Rubik: the hand's 24 joints, then the cube's free joint, then
# the six face hinges
MAX_MOVES = 10
_NHAND = 24
_QCUBE, _VCUBE = 24, 24
_QFACE, _VFACE = 31, 30


def _face_targets(g, dtype):
  """The face angles (6, ...) at goal stage g (...): the sum of the moves
  k < g, move k turning face (3k + 1) mod 6 by (1 - 2 (k mod 2)) pi / 2
  (solve.cc:160-165)."""
  cols = []
  for j in range(6):
    zero = torch.zeros(g.shape, dtype=dtype, device=g.device)
    tj = None
    for k in range(MAX_MOVES):
      if (3 * k + 1) % 6 != j:
        continue
      term = torch.where(g > k, zero + (1.0 - 2.0 * (k % 2)) * _HALF_PI,
                         zero)
      tj = term if tj is None else tj + term
    cols.append(zero if tj is None else tj)
  return torch.stack(cols)


def residual(model, data, params):
  """Residual (84, B) of "Rubik" on the component-leading,
  batch-trailing view."""
  mode, g = data.userdata[0], data.userdata[1]
  dtype = data.qpos.dtype
  goal = data.mocap_quat[0]
  goal = goal / sensors.norm0(goal)
  faces = data.qpos[_QFACE:_QFACE + 6]
  face_err = torch.where(mode == MODE_SOLVE,
                         faces - _face_targets(g, dtype), 0.0)
  home = base.const_column(model, "rubik_home_hand",
                           model.keyframe("home")[0][:_NHAND], data.qpos)
  return torch.cat([
      data.qpos[_QCUBE:_QCUBE + 3] - data.site_xpos[model.site("grasp_site")],
      sensors.quat_sub0(goal, data.qpos[_QCUBE + 3:_QCUBE + 7]),
      data.qvel[_VCUBE:_VCUBE + 3],
      data.actuator_force,
      torch.broadcast_to(face_err, (6,) + data.qpos.shape[1:]),
      data.qpos[:_NHAND] - home,
      data.qvel[:_NHAND],
      torch.broadcast_to((g * 12.0).to(dtype)[None],
                         (1,) + data.qpos.shape[1:]),
  ])


def transition(model, data, params):
  """The scramble, solve and wait FSM (solve.cc:141-241): in scramble
  mode the faces jump to the stack of min(max(params[0], 0), MAX_MOVES)
  moves at rest, g to one less, solve mode; in solve mode a stage within
  params[1] (the norm over the faces) moves g down by one, and at g 0
  to wait; a cube below z 0.1 (dropped) goes to wait."""
  n_moves = torch.clamp(params[0], 0.0, float(MAX_MOVES))
  tol = params[1]
  ud = data.userdata
  mode, g = ud[0], ud[1]
  dtype = data.qpos.dtype
  faces = data.qpos[_QFACE:_QFACE + 6]
  in_scramble = mode == MODE_SCRAMBLE
  new_faces = torch.where(in_scramble, _face_targets(n_moves, dtype)
                          .reshape((6,) + (1,) * (faces.dim() - 1)), faces)
  qpos = torch.cat([data.qpos[:_QFACE], new_faces,
                    data.qpos[_QFACE + 6:]])
  face_vel = torch.where(in_scramble, 0.0, data.qvel[_VFACE:_VFACE + 6])
  qvel = torch.cat([data.qvel[:_VFACE], face_vel, data.qvel[_VFACE + 6:]])
  err = torch.linalg.vector_norm(new_faces - _face_targets(g, dtype), dim=0)
  reached = (mode == MODE_SOLVE) & (err < tol)
  solved = reached & (g <= 0.0)
  new_mode = torch.where(in_scramble, float(MODE_SOLVE), mode)
  new_g = torch.where(in_scramble, torch.clamp(n_moves - 1.0, min=0.0), g)
  new_g = torch.where(reached & (g > 0.0), g - 1.0, new_g)
  new_mode = torch.where(solved, float(MODE_WAIT), new_mode)
  new_mode = torch.where(qpos[_QCUBE + 2] < 0.1, float(MODE_WAIT), new_mode)
  return data.replace(qpos=qpos, qvel=qvel, userdata=torch.cat([
      new_mode[None].to(ud.dtype), new_g[None].to(ud.dtype), ud[2:]]))


def build_rubik():
  """tasks/models/rubik_hand.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "rubik_hand.xml"))


@registry.register("Rubik", snapshot="rubik", builder=build_rubik)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("rubik", dtype,
                                                         device)
  return base.Task(name="Rubik", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   transition=transition)
