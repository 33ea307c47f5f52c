"""Allegro in-hand cube reorientation (reference:
mjpc/tasks/allegro/allegro.cc:28-76).

Counterpart of mujoco_mpc_tpu/tasks/allegro.py ("Allegro"): a 12-joint
primitive-geom hand (three parallel fingers and an opposing thumb, each an
abduction and two flexion joints on position actuators) under a free cube,
the goal orientation as the mocap body's quaternion. Contacts, all condim
3: the world-fixed palm box against the cube (16 box-box corner points),
the 8 finger capsules' ends against the cube and the cube's corners on the
floor.

Its transition is Shadow's goal-advance and drop-reset FSM
(hand_reorient.transition), as in the JAX package.

Residual layout (allegro.cc:38-73), hand_reorient.reorient_residual on the
world-fixed palm site with a hold offset of -0.04 in z:
  cube position - palm site - (0, 0, 0.04) (3), goal (-) cube orientation
  (3), cube linear velocity (3), actuator force (12), hand qpos - home
  (12), hand qvel (12).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, hand_reorient, registry

_NHAND = 12
_HOLD = (0.0, 0.0, 0.04)
_SITE = "palm_site"


def residual(model, data, params):
  """Residual (45, B), reorient_residual on the palm site."""
  return hand_reorient.reorient_residual(model, data, _SITE, _NHAND, _HOLD)


def probe_states(model, b: int, seed: int = 0):
  """(qpos (19, b), qvel (18, b), ctrl (12, b)) float32 numpy states in
  which every constraint row class carries force. State i % 5: 0 rests the
  cube face-down 2 mm into the palm, turned about the vertical and
  spinning (box-box corners of the cube); 1 sets it over a palm corner, so
  that the palm's corner presses into the cube's bottom face and the
  cube's inner corner into the palm (box-box corners of both boxes); 2
  drops it onto the floor, tipped (plane-box corners); in 0-2 the cube
  moves down. 3 curls the three fingers over the cube on the palm
  (capsule-box); 4 bends every finger past its joint ranges (joint
  limits)."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  qpos = np.repeat(home[None], b, 0)
  qpos[:, :_NHAND] += rng.uniform(-0.02, 0.02, (b, _NHAND))
  qadr, vadr = hand_reorient._cube_adr(model)
  kind = np.arange(b) % 5

  def adr(name):
    return model.jnt_qposadr[model.joint(name)]

  def yaw(angle):
    return np.stack([np.cos(angle / 2), 0 * angle, 0 * angle,
                     np.sin(angle / 2)], -1)

  # 0: face-down on the palm (top face z 0.262), turned and spinning
  qpos[:, qadr + 2] = 0.29 + rng.uniform(-0.001, 0.001, b)
  qpos[:, qadr + 3:qadr + 7] = yaw(rng.uniform(-0.3, 0.3, b))
  # 1: over the palm's (+x, -y) corner, clear of the fingers
  corner = kind == 1
  qpos[corner, qadr] = 0.065 - 0.015 + rng.uniform(-0.002, 0.002,
                                                    corner.sum())
  qpos[corner, qadr + 1] = -0.05 + 0.015 + rng.uniform(-0.002, 0.002,
                                                        corner.sum())
  qpos[corner, qadr + 3:qadr + 7] = yaw(np.zeros(corner.sum()))
  # 2: on the floor, tipped about x
  floor = kind == 2
  tip = rng.uniform(0.1, 0.3, floor.sum())
  qpos[floor, qadr] = 0.2
  qpos[floor, qadr + 2] = 0.03 * (np.cos(tip) + np.sin(tip)) - 0.002
  qpos[floor, qadr + 3:qadr + 7] = np.stack(
      [np.cos(tip / 2), np.sin(tip / 2), 0 * tip, 0 * tip], -1)
  # 3: the fingers curled over the cube on the palm, pressing it down
  curl = kind == 3
  for f in ("ff", "mf", "rf"):
    for j, val in (("mcp", 1.4), ("pip", 1.5)):
      qpos[curl, adr(f"{f}_{j}")] = val + rng.uniform(-0.02, 0.02,
                                                      curl.sum())
  # 4: every finger past its ranges
  past = kind == 4
  for f in ("ff", "mf", "rf"):
    qpos[past, adr(f"{f}_abd")] = 0.5
    qpos[past, adr(f"{f}_pip")] = -0.25
  qpos[past, adr("th_abd")] = -0.65
  qpos[past, adr("th_mcp")] = 0.25
  qvel = rng.uniform(-0.3, 0.3, (b, model.nv))
  # the cube moving into the palm or the floor
  down = kind <= 2
  qvel[down, vadr + 2] = rng.uniform(-0.3, -0.1, down.sum())
  spin = kind == 0
  qvel[spin, vadr + 5] = rng.uniform(3.0, 5.0, spin.sum())
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  ctrl = rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu))
  return tuple(np.ascontiguousarray(x.T, np.float32)
               for x in (qpos, qvel, ctrl))


def build_allegro():
  """The Allegro MJCF (tasks/models/allegro.xml) as a mujoco.MjModel
  (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "allegro.xml"))


@registry.register("Allegro", snapshot="allegro", builder=build_allegro)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "allegro", dtype, device)
  return base.Task(name="Allegro", model=model, spec=spec, params=params,
                   residual=residual, param_names=pnames,
                   transition=hand_reorient.transition,
                   device_residual=hand_reorient.device_residual(
                       model, _SITE, _NHAND, _HOLD))
