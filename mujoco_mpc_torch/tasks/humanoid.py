"""Humanoid stand and walk (reference: mjpc/tasks/humanoid/{stand,walk}).

Counterpart of mujoco_mpc_tpu/tasks/humanoid.py, on the full-DOF
dm_control humanoid (nq 28, nv 27, nu 21, two hamstring tendons). The walk
residual follows walk.cc:44-160 term by term: torso height, pelvis-feet
alignment, capture-point balance on the inter-foot segment, upright,
posture, walk-forward speed, move-feet and control, gated by the smooth
`standing` factor. Stand is the same residual with Speed 0.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_humanoid in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 2


def residual(model, data, params):
  """Residual (57, B); `data` fields are component-leading, batch-trailing
  (the tile view of physics/tilestep.py::step_tb)."""
  height_goal, speed_goal, balance_time = params[0], params[1], params[2]
  torso = model.body("torso")
  pelvis = model.body("pelvis")
  waist = model.body("lower_waist")
  rfoot = model.body("right_foot")
  lfoot = model.body("left_foot")

  def norm0(x):
    return torch.sqrt(torch.sum(x * x, dim=0))

  # torso height (walk.cc:48-50)
  torso_h = data.xpos[torso, 2]
  height = torso_h - height_goal

  # pelvis / feet (walk.cc:52-57)
  foot_r = data.xpos[rfoot]
  foot_l = data.xpos[lfoot]
  pelvis_feet = 0.5 * (foot_l[2] + foot_r[2]) - data.xpos[pelvis, 2] - 0.2

  # standing gate (walk.cc:92-94)
  standing = torso_h / torch.sqrt(torso_h * torso_h + 0.45 * 0.45) - 0.4

  # balance: capture point onto the inter-foot segment (walk.cc:59-100)
  subcom = data.subtree_com[torso]
  subcomvel = sensors.subtree_linvel(model, data, torso)
  capture = subcom[:2] + balance_time * subcomvel[:2]
  axis = (foot_r - foot_l)[:2]
  length = 0.5 * norm0(axis) - 0.05
  axis = axis / torch.clamp(norm0(axis), min=1e-9)
  center = 0.5 * (foot_r + foot_l)[:2]
  t = torch.clamp(torch.sum((capture - center) * axis, dim=0), -length,
                  length)
  pcp = center + t * axis
  balance = standing * (capture - pcp)

  # upright (walk.cc:102-122)
  up_torso = data.xmat[torso, 2, 2] - 1.0
  up_pelvis = 0.3 * (data.xmat[pelvis, 2, 2] - 1.0)
  zr = data.xmat[rfoot, :, 2]
  zl = data.xmat[lfoot, :, 2]
  up_rfoot = 0.1 * standing * torch.stack([zr[0], zr[1], zr[2] - 1.0])
  up_lfoot = 0.1 * standing * torch.stack([zl[0], zl[1], zl[2] - 1.0])
  upright = torch.cat([up_torso[None], up_pelvis[None], up_rfoot, up_lfoot])

  # posture (walk.cc:124-126)
  posture = data.qpos[7:]

  # walk forward (walk.cc:128-151)
  fwd = (data.xmat[torso, :2, 0] + data.xmat[pelvis, :2, 0] +
         data.xmat[rfoot, :2, 0] + data.xmat[lfoot, :2, 0])
  fwd = fwd / torch.clamp(norm0(fwd), min=1e-9)
  waist_vel = sensors.subtree_linvel(model, data, waist)[:2]
  torso_vel = (data.cvel[torso][3:] +
               sensors.cross0(data.cvel[torso][:3], data.xipos[torso]))[:2]
  com_vel = 0.5 * (waist_vel + torso_vel)
  walk = standing * (torch.sum(com_vel * fwd, dim=0) - speed_goal)

  # move feet (walk.cc:153-163)
  rfoot_vel = (data.cvel[rfoot][3:] +
               sensors.cross0(data.cvel[rfoot][:3], data.xipos[rfoot]))[:2]
  lfoot_vel = (data.cvel[lfoot][3:] +
               sensors.cross0(data.cvel[lfoot][:3], data.xipos[lfoot]))[:2]
  move_feet = standing * (com_vel - 0.5 * rfoot_vel - 0.5 * lfoot_vel)

  # control (walk.cc:165-167)
  control = data.ctrl

  return torch.cat([
      height[None], pelvis_feet[None], balance, upright, posture,
      walk[None], move_feet, control,
  ])


def probe_states(model, b: int, seed: int = 0):
  """(qpos (28, b), qvel (27, b), ctrl (21, b)) float32 numpy states in
  which every constraint row class carries force: state i % 8 in 0-2 lies
  on its back 7 cm up (head sphere, torso and limb capsule ends on the
  floor), 3-5 stands with the hips turned in (hip_x 25 deg, hip_z 30 deg)
  so thighs and shins cross (capsule-capsule, joint limits), 6-7 flexes
  the hips and straightens the knees past the hamstrings' range (tendon
  limits). The home keyframe alone touches none of these. Some crossings
  are stiff enough that float32 rounding order moves qvel by up to ~1e-3
  in one step (tests/test_torch_kernel_host.py)."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  qpos = np.repeat(home[None], b, 0)
  qpos[:, 7:] += rng.uniform(-0.05, 0.05, (b, 21))
  kind = np.arange(b) % 8
  back, cross, ham = kind < 3, (kind >= 3) & (kind < 6), kind >= 6
  qpos[back, 2] = 0.07 + rng.uniform(-0.01, 0.01, int(back.sum()))
  qpos[back, 3:7] = [np.sqrt(0.5), 0.0, -np.sqrt(0.5), 0.0]
  qpos[cross, 2] = 1.25
  for name, deg in (("hip_x", 25.0), ("hip_z", 30.0)):
    for side in ("right", "left"):
      qpos[cross, model.jnt_qposadr[model.joint(f"{side}_{name}")]] = \
          np.deg2rad(deg)
  qpos[ham, 2] = 1.3
  for side in ("right", "left"):
    qpos[ham, model.jnt_qposadr[model.joint(f"{side}_hip_y")]] = -1.6
    qpos[ham, model.jnt_qposadr[model.joint(f"{side}_knee")]] = 0.06
  qvel = rng.uniform(-0.5, 0.5, (b, model.nv))
  ctrl = rng.uniform(-1.0, 1.0, (b, model.nu))
  return tuple(np.ascontiguousarray(x.T, np.float32)
               for x in (qpos, qvel, ctrl))


def _device_residual(model) -> base.DeviceResidual:
  """residual_humanoid's operands: five body ids, the descendant sets of
  torso and lower_waist as body bitmasks, and their subtree masses."""
  torso, waist = model.body("torso"), model.body("lower_waist")

  def mask(root):
    return sum(1 << b for b in sensors._descendants(model, root))

  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (torso, model.body("pelvis"), waist, model.body("right_foot"),
       model.body("left_foot"), mask(torso), mask(waist)),
      (float(model.body_subtreemass[torso]),
       float(model.body_subtreemass[waist])))


def _make(name, speed, dtype, device):
  model, spec, params, pnames = registry.load_task_model(
      "humanoid", dtype, device)
  task = base.Task(name=name, model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   device_residual=_device_residual(model))
  return task.set_parameter("Speed", speed)


@registry.register("Humanoid Stand", snapshot="humanoid",
                   builder=dm_suite.build_humanoid)
def make_stand(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  return _make("Humanoid Stand", 0.0, dtype, device)


@registry.register("Humanoid Walk", snapshot="humanoid",
                   builder=dm_suite.build_humanoid)
def make_walk(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  return _make("Humanoid Walk", 1.0, dtype, device)
