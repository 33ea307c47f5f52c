"""Bimanual ALOHA-style handover (reference:
mjpc/tasks/bimanual/handover/handover.cc).

Counterpart of mujoco_mpc_tpu/tasks/bimanual.py ("Bimanual Handover"):
two mirrored 6-joint arms with two-finger grippers (each finger pair
coupled by a joint equality), 16 position actuators, a free condim-6 box
on a table and the target as the mocap body. Contacts are the box's 8
corners against the table and two points per finger capsule against the
box, all condim 6.

`transition` is the success, drop and timeout FSM (handover.cc:134-185):
a solved target moves across the table (userdata[0] counts solves,
userdata[1] holds the last solve's time), a box off the table and arms
stuck for 30 s without a solve go back to the home keyframe.

Residual layout (handover.cc:33-131), 26 entries:
  Reach L (3), Reach R (3): the box in the gripper site's frame, y and z
    doubled;
  Grasp (1): the geometric mean over hands of 0.5 (n_L . n_R + 1), n the
    mean contact normal of a finger (points within 2 cm of touching);
    1 for a hand without contact on both fingers;
  Bring (3): box - target;
  Velocity (16): the arms' joint velocities.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors, tilestep
from mujoco_mpc_torch.tasks import base, registry

# residual_handover in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 6

_NARM = 16  # 2 x (6 joints + 2 fingers)
_SOLVE_TIMEOUT = 30.0
_PHI = 0.6180339887498949  # golden-ratio conjugate: a low-discrepancy walk
_GRASP_MARGIN = 0.02  # handover task.xml:85: grasp normals count within it
_SITES = ("left/gripper", "right/gripper")
# the finger geoms, in the order the grasp term reads them
_FINGERS = ("left/fingerL_geom", "left/fingerR_geom", "right/fingerL_geom",
            "right/fingerR_geom")


def contact_slots(model, pairs):
  """(start, count, sign) of each finger-box pair (in _FINGERS order) among
  contact points whose geom pairs are `pairs` (ContactView.pairs, the
  TileModel.con_points order): the pair's first point, its number of
  points, and +1 where the pair is stored (finger, box), -1 where it is
  stored (box, finger) (collision.geom_pair_slots)."""
  box = model.geom("box_geom")
  out = []
  for name in _FINGERS:
    finger = model.geom(name)
    idx = [i for i, p in enumerate(pairs) if p in ((finger, box),
                                                   (box, finger))]
    if not idx:
      raise KeyError(f"geom pair ({name}, box_geom) has no contact points")
    out.append((idx[0], len(idx),
                1.0 if pairs[idx[0]] == (finger, box) else -1.0))
  return tuple(out)


def _gripper_frame_vec(model, data, site, point):
  """`point` in the site's frame, the lateral components doubled."""
  s = model.site(site)
  rel = point - data.site_xpos[s]
  mat = data.site_xmat[s]
  local = [sum(mat[k, i] * rel[k] for k in range(3)) for i in range(3)]
  return torch.stack([local[0], 2.0 * local[1], 2.0 * local[2]])


def _finger_normal(contact, slot):
  """(unit mean contact normal finger -> box, whether it has one) over the
  slot's points within _GRASP_MARGIN of touching."""
  start, count, sign = slot
  normals = contact.frame[start:start + count, 0] * sign  # (count, 3, B)
  active = contact.dist[start:start + count] < _GRASP_MARGIN
  avg = torch.sum(normals * active[:, None].to(normals.dtype), dim=0)
  nrm = sensors.norm0(avg)
  return avg / torch.clamp(nrm, min=1e-9), nrm > 1e-9


def _grasp_quality(model, data):
  """The geometric-mean grasp term of handover.cc:100-124 (1 = no grasp)."""
  slots = contact_slots(model, data.contact.pairs)
  quality = None
  for side in range(2):
    n1, h1 = _finger_normal(data.contact, slots[2 * side])
    n2, h2 = _finger_normal(data.contact, slots[2 * side + 1])
    hand = torch.where(h1 & h2, 0.5 * (sensors.dot0(n1, n2) + 1.0),
                       torch.ones_like(n1[0]))
    quality = hand if quality is None else quality * hand
  return torch.sqrt(torch.clamp(quality, min=0.0))


def residual(model, data, params):
  """Residual (26, B); `data` fields are component-leading, batch-trailing
  (the tile view of physics/tilestep.py::step_tb, with its ContactView),
  the mocap target with a trailing axis of 1."""
  box = data.xpos[model.body("box")]
  target = data.mocap_pos[0]
  return torch.cat([
      _gripper_frame_vec(model, data, _SITES[0], box),
      _gripper_frame_vec(model, data, _SITES[1], box),
      _grasp_quality(model, data)[None],
      box - target,
      data.qvel[:_NARM],
  ])


def transition(model, data, params):
  """The handover FSM of the JAX package (handover.cc:134-185): on
  success the target jumps to the table's other side at a low-discrepancy
  offset; a box below z -0.1 returns to its home pose at rest; after
  _SOLVE_TIMEOUT s without a solve, the whole state returns home."""
  box = data.xpos[model.body("box")]
  target = data.mocap_pos[0]
  size = model.const("handover_target_size", lambda: float(
      model.geom_size[model.geom("target_geom"), 0]))
  solved = torch.linalg.vector_norm(box - target, dim=0) < size
  ud = data.userdata
  count = ud[0] + torch.where(solved, 1.0, 0.0)
  u1 = torch.remainder(count * _PHI, 1.0)
  u2 = torch.remainder(count * _PHI * 7.0, 1.0)
  u3 = torch.remainder(count * _PHI * 13.0, 1.0)
  flip = torch.where(target[0] > 0, -1.0, 1.0)
  side = torch.where(u2 > 0.5, 1.0, -1.0)
  new_target = torch.stack([flip * (0.3 + 0.1 * u1),
                            side * (0.2 + 0.1 * u2), 0.25 + 0.45 * u3])
  mocap0 = torch.where(solved, new_target.to(target.dtype), target)
  solve_time = torch.where(solved, data.time, ud[1])
  home = base.const_column(model, "home_qpos", model.keyframe("home")[0],
                           data.qpos)
  fell = box[2] < -0.1
  qpos = torch.cat([data.qpos[:16],
                    torch.where(fell, home[16:23], data.qpos[16:23]),
                    data.qpos[23:]])
  qvel = torch.cat([data.qvel[:16],
                    torch.where(fell, 0.0, data.qvel[16:22]),
                    data.qvel[22:]])
  stuck = data.time > solve_time + _SOLVE_TIMEOUT
  qpos = torch.where(stuck, home, qpos)
  qvel = torch.where(stuck, 0.0, qvel)
  solve_time = torch.where(stuck, data.time, solve_time)
  return data.replace(
      qpos=qpos, qvel=qvel,
      mocap_pos=torch.cat([mocap0[None], data.mocap_pos[1:]]),
      userdata=torch.cat([count[None], solve_time[None].to(ud.dtype),
                          ud[2:]]))


# a horizontal pinch at the table's centre, 0.15 m up: lift, elbow and
# wrist pitch of either arm (pan, forearm roll and wrist rotation 0) that
# put the gripper site at (0, 0, 0.15) with its x axis level (solved on
# the forward kinematics, within 3e-5 m); the mirrored arms then hold the
# same point from either side
_PINCH = (-0.5482, 1.5906, -1.0425)
_PINCH_Z = 0.15
_FINGER_CLOSED = -0.008  # each finger's pad 2 mm into the box's side


def probe_states(model, b: int, seed: int = 0):
  """(qpos (23, b), qvel (22, b), ctrl (16, b)) float32 numpy states in
  which every constraint row class carries force. State i % 4:
    0 the box tipped onto an edge on the table, rolling about it and
      spinning (plane_boxcorner, torsional, rolling), the arms at home with
      joints past their ranges (joint limits), each finger pair pulled
      apart (the joint equality);
    1 both grippers pinching the box in the air from either side, a
      handover (cap_box, torsional, rolling), the box spinning about the
      pinch axis;
    2 as 1, each finger pair pulled apart the other way;
    3 the box resting on one corner, tumbling (plane_boxcorner, torsional,
      rolling), the fingers closed unevenly, arms past their ranges."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  qpos = np.repeat(home[None], b, 0)
  kind = np.arange(b) % 4
  qpos[:, :_NARM] += rng.uniform(-0.02, 0.02, (b, _NARM))

  def adr(name):
    return model.jnt_qposadr[model.joint(name)]

  box = model.jnt_qposadr[model.body_jntadr[model.body("box")]]
  box_v = model.jnt_dofadr[model.body_jntadr[model.body("box")]]
  # the finger pairs: 1 mm apart one way (kinds 0, 3) or the other (2)
  apart = np.where(kind == 2, -0.001, 0.001) + rng.uniform(
      -2e-4, 2e-4, b)
  pinch = (kind == 1) | (kind == 2)
  for side in ("left", "right"):
    for name, val in zip(("lift", "elbow", "pitch"), _PINCH):
      qpos[pinch, adr(f"{side}/{name}")] = val + rng.uniform(
          -0.002, 0.002, pinch.sum())
    for j in ("pan", "forearm_roll", "wrist_rotate"):
      qpos[pinch, adr(f"{side}/{j}")] = rng.uniform(-0.002, 0.002,
                                                    pinch.sum())
    closed = _FINGER_CLOSED + rng.uniform(-5e-4, 5e-4, b)
    qpos[:, adr(f"{side}/fingerL")] = closed + np.where(kind == 1, 0.0,
                                                        0.5 * apart)
    qpos[:, adr(f"{side}/fingerR")] = closed - np.where(kind == 1, 0.0,
                                                        0.5 * apart)
  qpos[pinch, box:box + 3] = [0.0, 0.0, _PINCH_Z]
  qpos[pinch, box + 3:box + 7] = [1.0, 0.0, 0.0, 0.0]
  # kind 0: tipped 20 degrees about x onto an edge; kind 3: onto a corner
  # (about x and y), each lowered 1 mm into the table
  half = 0.02
  for k, (ax, ay) in ((0, (0.35, 0.0)), (3, (0.3, 0.4))):
    sel = kind == k
    qx = np.array([np.cos(ax / 2), np.sin(ax / 2), 0.0, 0.0])
    qy = np.array([np.cos(ay / 2), 0.0, np.sin(ay / 2), 0.0])
    w1, x1, y1, z1 = qy
    w2, x2, y2, z2 = qx
    q = np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                  w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])
    # the lowest corner's height above the centre
    rot = _quat_mat(q)
    low = min((rot @ (half * np.array(c)))[2]
              for c in ((sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)))
    qpos[sel, box:box + 3] = [-0.15, 0.0, -low - 0.001]
    qpos[sel, box + 3:box + 7] = q
  # on the table states the shoulders past their ranges and moving on
  # outward, their commands at the limit (a position servo's damping would
  # otherwise stop a light joint before its limit row takes force)
  table = (kind == 0) | (kind == 3)
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  ctrl = rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu))
  qvel = rng.uniform(-0.3, 0.3, (b, model.nv))
  for joint, q, v in (("left/lift", -1.25, -2.0), ("right/lift", 1.65, 2.0)):
    qpos[table, adr(joint)] = q
    qvel[table, model.jnt_dofadr[model.joint(joint)]] = v
    u = model.actuator_names.index(joint.replace("/", "/a_"))
    ctrl[table, u] = crange[u, 0] if v < 0 else crange[u, 1]
  # the box: rolling about its edge and spinning (table), spinning about
  # the pinch axis y (held)
  qvel[:, box_v:box_v + 3] = rng.uniform(-0.05, 0.05, (b, 3))
  qvel[table, box_v + 3:box_v + 6] = rng.uniform(-3.0, 3.0,
                                                 (table.sum(), 3))
  qvel[pinch, box_v + 3:box_v + 6] = rng.uniform(-0.5, 0.5,
                                                 (pinch.sum(), 3))
  qvel[pinch, box_v + 4] = rng.uniform(2.0, 4.0, pinch.sum())
  return tuple(np.ascontiguousarray(x.T, np.float32)
               for x in (qpos, qvel, ctrl))


def _quat_mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _device_residual(model) -> base.DeviceResidual:
  """residual_handover's operands: the box body, the four finger-box
  slots' first points and point counts, their signs, and the two gripper
  sites with their orientations."""
  tm = tilestep.extract(model)
  slots = contact_slots(model, [(cp.g1, cp.g2) for cp in tm.con_points])
  spos = model.site_pos.detach().cpu().numpy()
  squat = model.site_quat.detach().cpu().numpy()
  sites = tuple((model.site_bodyid[s], tuple(float(x) for x in spos[s]),
                 tuple(float(x) for x in squat[s]))
                for s in (model.site(n) for n in _SITES))
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (model.body("box"),) + tuple(s for s, _, _ in slots)
      + tuple(c for _, c, _ in slots),
      tuple(g for _, _, g in slots), sites)


def build_bimanual():
  """The Handover MJCF (tasks/models/bimanual.xml) as a mujoco.MjModel
  (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "bimanual.xml"))


@registry.register("Bimanual Handover", snapshot="bimanual",
                   builder=build_bimanual)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "bimanual", dtype, device)
  return base.Task(name="Bimanual Handover", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   transition=transition,
                   device_residual=_device_residual(model))
