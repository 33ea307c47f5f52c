"""Inputs the mesh and heightfield tests share (Bimanual Insert, Quadruped
Hill and the pair functions): world-frame poses for each pair kind, probe
states in which every new pair kind carries force, and per-kind contact
forces. Importable without JAX or `mujoco` (chip_smoke.py reads it on the
card's host).

Probe states are built, not searched: each starts at the home keyframe
with the arm or leg joints perturbed, then a free body is moved along a
line (a connector lowered onto the table, moved into the other connector
or into a finger, the quadruped lowered onto the hill upright or on its
back) to the first point of a grid of 48 where the pair kind's deepest
point is DEPTH into the other geom, found with one batched kinematics and
collision pass on the CPU in float64."""

import os

import numpy as np
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.physics import collision as tcol
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import kinematics as tkin
from mujoco_mpc_torch.physics.types import GeomType, JointType

# the pair kinds each task adds to the general engine
NEW_KINDS = {"Bimanual Insert": {"plane-mesh", "box-mesh", "mesh-mesh"},
             "Quadruped Hill": {"hfield-sphere", "hfield-box"}}
DEPTH = 0.003  # how deep a placed pair's deepest point goes (m)
# lift, elbow and wrist pitch that put an arm's gripper 0.15 m over the
# table's centre (tasks/bimanual.py::_PINCH, the same arms)
PINCH = (-0.5482, 1.5906, -1.0425)
_GRID = 48

CONNECTOR_DIR = os.path.join(os.path.dirname(tio.__file__), os.pardir,
                             "tasks", "models", "assets", "connector")


# a plane, a sphere, a capsule, a box and the two connector hulls, each
# free: one candidate pair of every mesh kind
MESH_PAIRS_XML = f"""
<mujoco>
  <compiler angle="radian" meshdir="{os.path.abspath(CONNECTOR_DIR)}"/>
  <asset>
    <mesh name="m" file="mcX_m_collision_mcX_m_MESH.stl"/>
    <mesh name="f" file="mcX_f_collision_mcX_f_MESH.stl"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <body><freejoint/><geom name="sphere" type="sphere" size="0.015"/></body>
    <body><freejoint/><geom name="capsule" type="capsule"
      size="0.008 0.02"/></body>
    <body><freejoint/><geom name="box" type="box"
      size="0.012 0.02 0.009"/></body>
    <body><freejoint/><geom name="male" type="mesh" mesh="m"/></body>
    <body><freejoint/><geom name="female" type="mesh" mesh="f"/></body>
  </worldbody>
</mujoco>
"""


def _rotations(rng, b):
  q = rng.randn(b, 4)
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)


def pair_poses(kind, b, seed=0):
  """(pos (b, 2, 3), mat (b, 2, 3, 3)) world poses of geom 1 (the plane,
  a primitive or the female hull) and the male hull. Pose 0 is axis
  aligned, the hull's flat faces parallel to the plane or the box, so
  that hull vertices tie in depth; the others are turned at random, the
  two centres 1 to 5 cm apart (a plane's 1 cm above or below the hull's
  centre)."""
  rng = np.random.RandomState(seed)
  mat = _rotations(rng, 2 * b).reshape(b, 2, 3, 3)
  mat[0] = np.eye(3)
  pos = np.zeros((b, 2, 3))
  if kind == "plane":
    mat[:, 0] = np.eye(3)
    pos[:, 1, 2] = rng.uniform(-0.01, 0.04, b)
    pos[0, 1, 2] = 0.02
  else:
    u = rng.randn(b, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u[0] = (0.0, 0.0, 1.0)
    pos[:, 1] = u * rng.uniform(0.01, 0.05, b)[:, None]
    pos[0, 1] = (0.0, 0.0, 0.03)
  pos += rng.uniform(-0.2, 0.2, (b, 1, 3))
  return pos, mat


def hfield_poses(kind, b, seed=0):
  """(hp (b, 3), hm (b, 3, 3), pos (b, 3), mat (b, 3, 3), size (3,)) for a
  geom of `kind` over Quadruped Hill's 8 x 8 m field: the field turned
  about a random axis by up to 0.3 rad and moved, the geom anywhere over
  it within 3 cm of the surface height range; but pose 0 puts the geom
  over the unturned field's far corner (local x = y = 8) and pose 1
  beyond it."""
  rng = np.random.RandomState(seed)
  size = {"sphere": (0.03, 0.0, 0.0), "capsule": (0.02, 0.05, 0.0),
          "box": (0.25, 0.12, 0.05)}[kind]
  axis = rng.randn(b, 3)
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  ang = rng.uniform(0, 0.3, b)
  k = np.zeros((b, 3, 3))
  k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
  k -= k.transpose(0, 2, 1)
  hm = (np.eye(3) + np.sin(ang)[:, None, None] * k +
        (1 - np.cos(ang))[:, None, None] * (k @ k))
  hp = rng.uniform(-0.5, 0.5, (b, 3))
  local = np.stack([rng.uniform(-8, 8, b), rng.uniform(-8, 8, b),
                    rng.uniform(-0.03, 0.53, b)], -1)
  local[0, :2] = (8.0, 8.0)
  local[1, :2] = (8.3, 8.1)
  hm[:2], hp[:2] = np.eye(3), 0.0
  pos = hp + np.einsum("bij,bj->bi", hm, local)
  return hp, hm, pos, _rotations(rng, b), np.asarray(size)


def _kinds_of_points(model):
  """The pair kind ("plane-mesh", ...) of each contact point."""
  out = []
  for (start, count), pair in zip(tcol.pair_slots(model),
                                  model.collision_pairs):
    out.extend(["-".join(GeomType(model.geom_type[g]).name.lower()
                         for g in pair)] * count)
  return np.asarray(out)


def force_by_kind(model, contact):
  """{pair kind: contact forces (..., points of the kind, 3)} as numpy;
  contact a port Contact (or any object with its `force`), points in slot
  order."""
  kinds = _kinds_of_points(model)
  f = contact.force.detach().cpu().numpy()
  return {str(k): f[..., kinds == k, :] for k in sorted(set(kinds))}


def active_kinds(model, d):
  """The pair kinds whose points carry force in some state of a stepped
  batch Data."""
  return {k for k, f in force_by_kind(model, d.contact).items()
          if np.any(f != 0)} & set().union(*NEW_KINDS.values())


def _free_qpos(model, body):
  for j, jt in enumerate(model.jnt_type):
    if jt == JointType.FREE and model.jnt_bodyid[j] == body:
      return model.jnt_qposadr[j]
  raise KeyError(body)


def _points_of(model, geoms_a, geoms_b):
  """Contact-point indices of the pairs with one geom in each set."""
  idx = []
  for (start, count), (g1, g2) in zip(tcol.pair_slots(model),
                                      model.collision_pairs):
    if (g1 in geoms_a and g2 in geoms_b) or (g2 in geoms_a and
                                             g1 in geoms_b):
      idx.extend(range(start, start + count))
  return idx


def _kinematics(model, qpos):
  """(geom_xpos (b, ngeom, 3), contact dist (b, npt)) of qpos (b, nq)."""
  d = trollout.broadcast(tio.make_data(model), (qpos.shape[0],))
  d = tkin.kinematics(model, d.replace(qpos=torch.as_tensor(qpos)))
  d = tcol.collide(model, d)
  return d.geom_xpos.numpy(), d.contact.dist.numpy()


def _place(model, qpos, adr, start, direction, points, span):
  """qpos with the free joint at adr moved to start + s direction, s the
  first of a grid over [0, span] at which the deepest of `points` reaches
  DEPTH (the last of the grid if none does)."""
  s = np.linspace(0.0, span, _GRID)
  q = np.repeat(qpos[None], _GRID, 0)
  q[:, adr:adr + 3] = start + s[:, None] * direction
  _, dist = _kinematics(model, q)
  deep = dist[:, points].min(1) <= -DEPTH
  return q[int(np.argmax(deep)) if deep.any() else -1]


def _geom_offset(model, qpos, adr, geom):
  """The geom centre minus the free body's position."""
  gx, _ = _kinematics(model, qpos[None])
  return gx[0, geom] - qpos[adr:adr + 3]


def _perturbed(model, rng, q, scale):
  """q with every limited hinge or slide joint moved by up to scale of
  its range about q, within the range."""
  q = q.copy()
  lim = model.jnt_range.detach().cpu().numpy()
  for j, jt in enumerate(model.jnt_type):
    if jt in (JointType.HINGE, JointType.SLIDE) and model.jnt_limited[j]:
      a = model.jnt_qposadr[j]
      lo, hi = lim[j]
      q[a] = np.clip(q[a] + scale * (hi - lo) * rng.uniform(-1, 1), lo, hi)
  return q


def _insert_state(model, rng, i, home):
  q = _perturbed(model, rng, home, 0.05)
  fem, male = model.body("female"), model.body("male")
  fa, ma = _free_qpos(model, fem), _free_qpos(model, male)
  geoms = {n: model.geom(n) for n in ("table", "female_geom", "male_geom")}
  scenario = i % 4
  if scenario == 0:  # both connectors onto the table, turned about z
    for adr in (fa, ma):
      yaw = rng.uniform(-np.pi, np.pi)
      qz = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
      w1, v1 = qz[0], qz[1:]
      w2, v2 = q[adr + 3], q[adr + 4:adr + 7]
      q[adr + 3] = w1 * w2 - v1 @ v2
      q[adr + 4:adr + 7] = w1 * v2 + w2 * v1 + np.cross(v1, v2)
    pts = _points_of(model, {geoms["table"]},
                     {geoms["female_geom"], geoms["male_geom"]})
    start = np.stack([q[fa:fa + 3], q[ma:ma + 3]]) + [0, 0, 0.02]

    def lowered(qq, dz):
      qq = qq.copy()
      qq[fa:fa + 3] = start[0] - [0, 0, dz]
      qq[ma:ma + 3] = start[1] - [0, 0, dz]
      return qq
    grid = np.stack([lowered(q, dz) for dz in np.linspace(0, 0.04, _GRID)])
    _, dist = _kinematics(model, grid)
    deep = dist[:, pts].min(1) <= -DEPTH
    return grid[int(np.argmax(deep)) if deep.any() else -1]
  if scenario == 1:  # the male connector into the female one, above it
    u = rng.randn(3)
    u[2] = abs(u[2]) + 1.0
    u /= np.linalg.norm(u)
    q[fa + 2] += 0.1
    target = _geom_offset(model, q, fa, geoms["female_geom"]) + q[fa:fa + 3]
    off = _geom_offset(model, q, ma, geoms["male_geom"])
    pts = _points_of(model, {geoms["female_geom"]}, {geoms["male_geom"]})
    return _place(model, q, ma, target - off + 0.12 * u, -u, pts, 0.12)
  # a connector between the fingers of its hand, the hand over the table
  # (the handover's pinch pose), pushed into one finger
  side, conn, adr = (("left", "female_geom", fa) if scenario == 2 else
                     ("right", "male_geom", ma))
  arm = model.jnt_qposadr[model.joint(f"{side}/pan")]
  q[arm + 1], q[arm + 2], q[arm + 4] = PINCH
  fl, fr = model.geom(f"{side}/fingerL_geom"), model.geom(f"{side}/fingerR_geom")
  gx, _ = _kinematics(model, q[None])
  mid = 0.5 * (gx[0, fl] + gx[0, fr])
  u = gx[0, fl] - gx[0, fr]
  u /= np.linalg.norm(u)
  off = _geom_offset(model, q, adr, geoms[conn])
  pts = _points_of(model, {fl}, {geoms[conn]})
  return _place(model, q, adr, mid - off, u, pts, 0.08)


def _hill_state(model, rng, i, home):
  q = _perturbed(model, rng, home, 0.05)
  trunk = model.body("trunk")
  adr = _free_qpos(model, trunk)
  yaw = rng.uniform(-np.pi, np.pi)
  on_back = i % 2 == 1
  if on_back:  # turned over about x, then yawed
    qt = np.array([0.0, np.cos(yaw / 2), np.sin(yaw / 2), 0.0])
  else:
    qt = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
  q[adr + 3:adr + 7] = qt
  xy = np.array([rng.uniform(2.5, 5.5), rng.uniform(-1.5, 1.5)])
  q[adr:adr + 2] = xy
  q[adr + 2] = 1.5
  terrain = model.geom("terrain")
  others = ({model.geom("trunk_geom")} if on_back else
            {g for g in range(model.ngeom)
             if model.geom_type[g] == GeomType.SPHERE})
  pts = _points_of(model, {terrain}, others)
  return _place(model, q, adr, q[adr:adr + 3],
                np.array([0.0, 0.0, -1.0]), pts, 1.5)


def probe_states(name, model, b, seed=0):
  """{"qpos": (b, nq), "qvel": (b, nv), "ctrl": (b, nu)} float64 numpy
  probe states of Bimanual Insert (state i % 4: both connectors on the
  table; the male connector into the female one; the female connector
  between the left fingers and into one; the male between the right
  fingers and into one) or Quadruped Hill (even states standing on the
  hill's slope, odd ones on the back), small random velocities and
  controls."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float64)
  build = _insert_state if name == "Bimanual Insert" else _hill_state
  qpos = np.stack([build(model, rng, i, home) for i in range(b)])
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  return {"qpos": qpos, "qvel": rng.uniform(-0.1, 0.1, (b, model.nv)),
          "ctrl": rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu))}


def far_edge_state(model):
  """Quadruped Hill's home pose over the field's far corner (x = y = 8):
  its feet sample the last row and column, and beyond."""
  q = np.asarray(model.keyframe("home")[0], np.float64).copy()
  adr = _free_qpos(model, model.body("trunk"))
  q[adr:adr + 3] = (7.95, 7.95, 0.3)
  return {"qpos": q[None], "qvel": np.zeros((1, model.nv)),
          "ctrl": np.zeros((1, model.nu))}


# each task's plan operands: Insert's target over the table's centre; on
# Hill the goal up the hill, the FSM trotting
GOALS = {"Bimanual Insert": [[0.05, -0.02, 0.25]],
         "Quadruped Hill": [[4.0, 0.5, 0.6]]}


def operands(name, model):
  """(mocap_pos (nmocap, 3), mocap_quat (nmocap, 4), userdata
  (nuserdata,)) float32 numpy of a task's plan, as
  tests/torch_flat_cases.py::operands gives them."""
  from mujoco_mpc_torch.tasks import quadruped as tquad
  mp = np.asarray(GOALS[name], np.float32)
  mq = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (model.nmocap, 1))
  ud = (tquad.fsm_userdata(model.nuserdata, tquad.MODE_QUADRUPED,
                           tquad.GAIT_TROT) if name == "Quadruped Hill"
        else np.zeros(model.nuserdata, np.float32))
  return mp, mq, ud
