"""Shadow-hand in-hand cube reorientation (reference:
mjpc/tasks/shadow_reorient/hand.cc).

Counterpart of mujoco_mpc_tpu/tasks/hand_reorient.py ("Shadow"): 24 hand
joints, 20 position actuators (the four fingers' distal J1+J2 pairs driven
through fixed tendons: actuators 4, 7, 10 and 14), a free cube, and the goal
orientation as the mocap body's quaternion. Contacts are the distal
capsules' ends and four palm pads against the cube, all condim 4.

`transition` is the goal-advance and drop-reset FSM (Allegro's too): a
goal reached within residual_Tolerance moves on along a deterministic
sequence (userdata[0] counts them), and a dropped cube goes back into the
hand at rest.

Residual layout (hand.cc:36-85):
  cube position - grasp site (3), goal (-) cube orientation (3), cube
  linear velocity (3), actuator force (nu = 20), hand qpos - home (24),
  hand qvel (24).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, registry

# residual_reorient in csrc/megarollout.cu (Shadow and Allegro)
DEVICE_RESIDUAL_ID = 4

_NHAND = 24
_GOLDEN = 2.39996322972865332  # radians
# the cube's pose and velocity after a drop
_CUBE_HOME = (0.0, 0.0, 0.285, 1.0, 0.0, 0.0, 0.0)


def _cube_adr(model):
  j = model.body_jntadr[model.body("cube")]
  return model.jnt_qposadr[j], model.jnt_dofadr[j]


def reorient_residual(model, data, site: str, nhand: int,
                      hold=(0.0, 0.0, 0.0)):
  """The in-hand reorientation residual of a hand with `nhand` joints
  first in qpos and a free cube: cube position - site - hold (3), goal (-)
  cube orientation (3), cube linear velocity (3), actuator force (nu), hand
  qpos - home (nhand), hand qvel (nhand). `data` fields are
  component-leading, batch-trailing (the tile view of
  physics/tilestep.py::step_tb), the mocap quaternion with a trailing axis
  of 1. csrc/megarollout.cu::residual_reorient computes it on the card."""
  qadr, vadr = _cube_adr(model)
  cube_pos = data.qpos[qadr:qadr + 3]
  cube_quat = data.qpos[qadr + 3:qadr + 7]
  rel = cube_pos - data.site_xpos[model.site(site)]
  goal = data.mocap_quat[0]
  goal = goal / sensors.norm0(goal)
  home = model.keyframe("home")[0]
  return torch.cat([
      torch.stack([rel[i] - float(hold[i]) for i in range(3)]),
      sensors.quat_sub0(goal, cube_quat),
      data.qvel[vadr:vadr + 3],
      data.actuator_force,  # hand.cc:73 reads actuator_force, not ctrl
      torch.stack([data.qpos[i] - float(home[i]) for i in range(nhand)]),
      data.qvel[:nhand],
  ])


def residual(model, data, params):
  """Residual (77, B), reorient_residual on the grasp site."""
  return reorient_residual(model, data, "grasp_site", _NHAND)


def transition(model, data, params):
  """Goal advance and drop reset (the JAX package's FSM; counter in
  userdata[0]): once the cube is within params[0] of the goal orientation
  (the norm of mju_subQuat's rotation vector), the goal moves to the next
  of a golden-angle sequence about a wandering axis; a cube below z 0.15
  goes back to _CUBE_HOME at rest."""
  tol = params[0]
  qadr, vadr = _cube_adr(model)
  cube_pos = data.qpos[qadr:qadr + 3]
  cube_quat = data.qpos[qadr + 3:qadr + 7]
  goal = data.mocap_quat[0]
  goal = goal / torch.linalg.vector_norm(goal, dim=0)
  err = pmath.quat_sub(torch.movedim(goal, 0, -1),
                       torch.movedim(cube_quat, 0, -1))
  reached = torch.linalg.vector_norm(err, dim=-1) < tol
  idx = data.userdata[0] + torch.where(reached, 1.0, 0.0)
  ang = _GOLDEN * idx
  raw = torch.stack([torch.sin(1.7 * idx), torch.cos(2.3 * idx),
                     torch.sin(0.9 * idx + 1.0)])
  axis = raw / torch.clamp(torch.linalg.vector_norm(raw, dim=0), min=1e-9)
  new_goal = torch.cat([torch.cos(ang / 2)[None], torch.sin(ang / 2) * axis])
  goal2 = torch.where(reached, new_goal.to(goal.dtype), goal)
  dropped = cube_pos[2] < 0.15
  home = base.const_column(model, "cube_home", _CUBE_HOME, data.qpos)
  cube_q = torch.where(dropped, home, data.qpos[qadr:qadr + 7])
  qpos = torch.cat([data.qpos[:qadr], cube_q, data.qpos[qadr + 7:]])
  cube_v = torch.where(dropped, 0.0, data.qvel[vadr:vadr + 6])
  qvel = torch.cat([data.qvel[:vadr], cube_v, data.qvel[vadr + 6:]])
  mocap_quat = torch.cat([goal2[None], data.mocap_quat[1:]])
  userdata = torch.cat([idx[None], data.userdata[1:]])
  return data.replace(qpos=qpos, qvel=qvel, mocap_quat=mocap_quat,
                      userdata=userdata)


def probe_states(model, b: int, seed: int = 0):
  """(qpos (31, b), qvel (30, b), ctrl (20, b)) float32 numpy states in
  which every constraint row class carries force. State i % 4: 0 rests the
  cube 2 mm into the palm pads, spinning about the vertical (sphere-box and
  their torsional rows); 1 curls the four fingers onto the lowered cube
  (capsule-box, torsional); 2 bends every finger past its joint ranges
  (joint limits); 3 lifts the cube onto the curled fingertips, spinning
  (capsule-box and torsional rows without the pads)."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  qpos = np.repeat(home[None], b, 0)
  qpos[:, :_NHAND] += rng.uniform(-0.02, 0.02, (b, _NHAND))
  qadr, vadr = _cube_adr(model)
  kind = np.arange(b) % 4

  def adr(name):
    return model.jnt_qposadr[model.joint(name)]

  qpos[:, qadr + 2] = 0.282 + rng.uniform(-0.001, 0.001, b)
  curl = (kind == 1) | (kind == 3)
  for f in ("FF", "MF", "RF", "LF"):
    for j, val in (("J3", 1.25), ("J2", 1.0), ("J1", 1.0)):
      qpos[curl, adr(f + j)] = val + rng.uniform(-0.02, 0.02, curl.sum())
  past = kind == 2
  for f in ("FF", "MF", "RF", "LF"):
    qpos[past, adr(f + "J4")] = 0.45
    qpos[past, adr(f + "J3")] = -0.4
  qpos[past, adr("THJ5")] = 1.2
  lift = kind == 3
  qpos[lift, qadr + 2] = 0.3
  qvel = rng.uniform(-0.3, 0.3, (b, model.nv))
  spin = (kind == 0) | (kind == 3)
  qvel[spin, vadr + 5] = rng.uniform(3.0, 5.0, spin.sum())
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  ctrl = rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu))
  return tuple(np.ascontiguousarray(x.T, np.float32)
               for x in (qpos, qvel, ctrl))


def device_residual(model, site: str, nhand: int,
                    hold=(0.0, 0.0, 0.0)) -> base.DeviceResidual:
  """residual_reorient's operands: the cube's qpos and dof addresses and
  the hand's joint count; the hold offset and the home keyframe's hand
  angles; the site."""
  sid = model.site(site)
  spos = model.site_pos.detach().cpu().numpy()[sid]
  home = model.keyframe("home")[0]
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID, tuple(int(x) for x in _cube_adr(model)) + (nhand,),
      tuple(float(x) for x in hold) + tuple(float(x) for x in home[:nhand]),
      ((model.site_bodyid[sid], tuple(float(x) for x in spos)),))


def build_hand_reorient():
  """The Shadow MJCF (tasks/models/hand_reorient.xml) as a mujoco.MjModel
  (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models",
                   "hand_reorient.xml"))


@registry.register("Shadow", snapshot="hand_reorient",
                   builder=build_hand_reorient)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "hand_reorient", dtype, device)
  return base.Task(name="Shadow", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   transition=transition,
                   device_residual=device_residual(model, "grasp_site",
                                                   _NHAND))
