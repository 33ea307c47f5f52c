"""PickAndPlace: a Panda-style arm brings a free box to a 6-DoF target
pose, then retreats (reference: mjpc/tasks/manipulation/
manipulation.cc:31-101, common.cc).

Counterpart of mujoco_mpc_tpu/tasks/bring.py ("PickAndPlace") on
tasks/models/panda_bring.xml, the JAX package's MJCF. The target pose is
mocap body 0; userdata[0] holds the phase (0 bring, 1 away) that
`weight_mod` reads and `transition` moves on, userdata[1] the count of
targets placed.

Residual layout, 13 + 7 entries:
  Reach (3): the gripper's centre (the two finger geoms' mean) - the box;
  Bring (8): the distance of each box corner to the target's;
  Careful (1): log10(1 + the sum of the contact force norms over the
    palm-table points) (common.cc:210-229);
  Away (1): min(0, the gripper's height - 0.25);
  Velocity (7): the arm's and fingers' joint velocities.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, registry

# residual_pick_and_place in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 16

_PHI = 0.6180339887498949
_AWAY_HEIGHT = 0.25
_T_REACH, _T_AWAY = 0, 3
_NTERM = 5
MODE_NAMES = ("bring", "away")
_CORNERS = np.asarray([(sx, sy, sz) for sx in (-1.0, 1.0)
                       for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)])
_FINGERS = ("fingerL_geom", "fingerR_geom")


def _hand_pos(model, data):
  """The gripper's centre: the finger geoms' mean (common.cc:231-236)."""
  g = [data.geom_xpos[model.geom(n)] for n in _FINGERS]
  return 0.5 * (g[0] + g[1])


def _corners(model, pos, mat):
  """The 8 corners (8, 3, ...) of a box of the object's size at pos, mat
  (3, ...), (3, 3, ...)."""
  size = model.geom_size[model.geom("object_geom")].detach().cpu().numpy()
  offs = base.const_column(model, "bring_corners",
                           (_CORNERS * size).reshape(-1), pos)
  offs = offs.reshape((8, 3) + offs.shape[1:])
  rot = [sum(mat[i, k] * offs[:, k] for k in range(3)) for i in range(3)]
  return pos[None] + torch.stack(rot, dim=1)


def palm_table_points(pairs, model):
  """The indices of the contact points of the palm-table pair among
  points whose geom pairs are `pairs` (a view's contact.pairs)."""
  palm, table = model.geom("palm"), model.geom("table")
  return [i for i, p in enumerate(pairs) if p in ((palm, table),
                                                  (table, palm))]


def _careful(model, data):
  """log10(1 + the sum over the palm-table points of |force|)."""
  idx = palm_table_points(data.contact.pairs, model)
  f = data.contact.force[idx]  # (count, 3, B)
  total = torch.sum(torch.sqrt(torch.sum(f * f, dim=1)), dim=0)
  return torch.log10(total + 1.0)


def _bring(model, data):
  """The corner distances (8, B) of the box to the target."""
  obj, tgt = model.body("object"), model.body("target")
  d = (_corners(model, data.xpos[obj], data.xmat[obj])
       - _corners(model, data.xpos[tgt], data.xmat[tgt]))
  return torch.sqrt(torch.sum(d * d, dim=1))


def residual(model, data, params):
  """Residual (20, B) on the component-leading, batch-trailing view (with
  the contact forces of the step, `contact.force`)."""
  hand = _hand_pos(model, data)
  return torch.cat([
      hand - data.xpos[model.body("object")],
      _bring(model, data),
      _careful(model, data)[None],
      torch.clamp(hand[2] - _AWAY_HEIGHT, max=0.0)[None],
      data.qvel[:7],
  ])


def weight_mod(model, data, params):
  """The phase's Reach and Away weights (manipulation.cc:70-80): Reach
  1 - phase, Away phase, the others 1; a (5, ...) multiplier."""
  phase = data.userdata[0]
  one = phase * 0.0 + 1.0
  rows = [one] * _NTERM
  rows[_T_REACH] = 1.0 - phase
  rows[_T_AWAY] = phase
  return torch.stack(rows)


def transition(model, data, params):
  """The two-phase FSM of the JAX package: in phase 0 (bring), once the
  corners are within 4 cm on average (after time 0), phase 1 (away); in
  phase 1, once the gripper is within 1 cm of 0.25 m up, a new target
  pose on a golden-ratio sequence, the count up by one, phase 0."""
  obj, tgt = model.body("object"), model.body("target")
  d = (_corners(model, data.xpos[obj], data.xmat[obj])
       - _corners(model, data.xpos[tgt], data.xmat[tgt]))
  bring_err = torch.mean(torch.linalg.vector_norm(d, dim=1), dim=0)
  hand = _hand_pos(model, data)
  ud = data.userdata
  phase, count = ud[0], ud[1]
  to_away = (phase == 0.0) & (data.time > 0) & (bring_err < 0.04)
  to_bring = (phase == 1.0) & (hand[2] - _AWAY_HEIGHT > -0.01)
  count2 = count + torch.where(to_bring, 1.0, 0.0)
  u = [torch.remainder(count2 * _PHI * k, 1.0)
       for k in (1.0, 7.0, 13.0, 29.0)]
  raw = torch.stack([2 * x - 1 for x in u])
  quat = raw / torch.clamp(torch.linalg.vector_norm(raw, dim=0), min=1e-9)
  new_pos = torch.stack([0.1 * (2 * u[0] - 1), 0.1 * (2 * u[1] - 1),
                         0.12 + 0.1 * u[2]])
  mp, mq = data.mocap_pos, data.mocap_quat
  pos = torch.where(to_bring, new_pos.to(mp.dtype), mp[0])
  q = torch.where(to_bring, quat.to(mq.dtype), mq[0])
  new_phase = torch.where(to_away, 1.0, torch.where(to_bring, 0.0, phase))
  return data.replace(
      mocap_pos=torch.cat([pos[None], mp[1:]]),
      mocap_quat=torch.cat([q[None], mq[1:]]),
      userdata=torch.cat([new_phase[None].to(ud.dtype),
                          count2[None].to(ud.dtype), ud[2:]]))


def _device_residual(model) -> base.DeviceResidual:
  """residual_pick_and_place's operands: the object and target bodies,
  the palm-table points' first constraint row, their number and rows per
  point; the object's half-sizes; the finger geoms' centres."""
  from mujoco_mpc_torch.physics import tilestep
  tm = tilestep.extract(model)
  fric, ones, _, _ = tilestep.row_points(tm)
  palm, table = model.geom("palm"), model.geom("table")
  pts = [k for k, cp in enumerate(fric + ones)
         if (cp.g1, cp.g2) in ((palm, table), (table, palm))]
  nr = 3 if pts[0] < len(fric) else 1
  row0 = 3 * pts[0] if nr == 3 else 3 * len(fric) + pts[0] - len(fric)
  size = model.geom_size.detach().cpu().numpy()[model.geom("object_geom")]
  gpos = model.geom_pos.detach().cpu().numpy()
  sites = tuple((model.geom_bodyid[g], tuple(float(x) for x in gpos[g]))
                for g in (model.geom(n) for n in _FINGERS))
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (model.body("object"), model.body("target"), row0, len(pts), nr),
      tuple(float(x) for x in size), sites)


def build_bring():
  """tasks/models/panda_bring.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "panda_bring.xml"))


@registry.register("PickAndPlace", snapshot="pick_and_place",
                   builder=build_bring)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "pick_and_place", dtype, device)
  return base.Task(name="PickAndPlace", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   transition=transition, weight_mod=weight_mod,
                   mode_names=MODE_NAMES,
                   device_residual=_device_residual(model))
