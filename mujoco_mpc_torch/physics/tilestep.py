"""Tile-layout physics step for the megakernel's model class.

Counterpart of mujoco_mpc_tpu/physics/tilestep.py. `extract` turns a Model
into a TileModel of host (numpy) constants; `step_tb` is the plain PyTorch
version of one semi-implicit Euler step with the batch dimension trailing
(qpos (nq, B)), as in JAX. The CUDA kernel (csrc/megarollout.cu) computes
the same step, one thread per candidate; `step_tb` is what it is held
against, and what runs when the tensors lie on the CPU.

The class this port covers, the whole of the JAX kernel's: hinge, slide,
ball and free joints, actuators (fixed or affine gain/bias) on scalar
joints or fixed tendons, scalar-joint springs and friction loss, fixed
tendons with limits, springs and dampers, mocap bodies (poses are
rollout-constant operands; no joints, no colliding geoms), contacts of a
world plane against sphere, capsule and cylinder ends and box corners, of
sphere against sphere, capsule and box, of capsule against capsule, of
capsule ends against a box, and of box against box (the corners of each
against the other's face-SAT slab), with condim 1, 3, 4 or 6, joint
limits, joint, connect and weld equality constraints, and the dense or
matrix-free Delassus solve. Everything else raises
UnsupportedModel, with the JAX extract's reason where it refuses the same,
naming the ROADMAP item that ports it: the general engine.

Constraint rows are in the tile layout: condim>=3 points (n, t1, t2 each),
condim-1 points (n), torsional rows (one per condim>=4 point), rolling rows
(one per condim-6 point about the first tangent, then one per point about
the second), joint limits (lo, hi each), tendon limits (lo, hi each),
equality rows (1 per joint, 3 per connect, 6 per weld) -- the same layout
as the JAX tile path, so the duals compare row by row.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_torch.physics.types import (ActDyn, EqType, GainBias,
                                            GeomType, JointType, Model,
                                            TrnType)

_ITERATIONS = 12  # warm-started APGD iterations (physics/solver.py)
_POWER_ITERS = 8  # power iterations for the matrix-free step size
# closest points nearer than COINCIDE machine epsilons of their coordinates
# coincide, and a sphere's centre that near a box's mid-plane lies on it
# (_contact_geometry, _sphere_box_point): the offset there is rounding, so
# no normal is taken from it (the reference takes one; ROADMAP queue 3)
COINCIDE = 64.0
_MINIMP, _MAXIMP = 1e-4, 0.9999
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)


class UnsupportedModel(Exception):
  """Model is outside the megakernel's supported class."""


def amat_is_dense(nrow: int) -> bool:
  """Whether the (nrow, nrow) Delassus matrix is materialized or the
  constraint solve runs matrix-free (the JAX package's threshold)."""
  return nrow * nrow * 4096 <= 4 * 1024 * 1024


def _unsupported(what: str, item: str):
  raise UnsupportedModel(f"{what}: not in the ported kernel class yet "
                         f"(ROADMAP {item})")


_GENERAL = "queue 1 items 3 and 6, the general engine"


# ---------------------------------------------------------------------------
# build-time extraction: model constants as numpy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConPoint:
  """One static candidate contact point."""
  kind: str  # 'plane_sphere' | 'plane_capend' | 'plane_boxcorner'
  #            | 'sphere_sphere' | 'sphere_cap' | 'sphere_box' | 'cap_cap'
  #            | 'cap_box' | 'boxbox_corner'
  g1: int
  g2: int
  body1: int
  body2: int
  sign: float  # +-1 capsule-end selector (plane_capend, cap_box), else 0
  r1: float
  r2: float
  half1: float
  half2: float
  frame: Optional[np.ndarray]  # (3, 3) constant frame of plane contacts
  ppos: Optional[np.ndarray]  # (3,) plane point of plane contacts
  mu: float
  solref: np.ndarray
  solimp: np.ndarray
  margin: float
  size1: Optional[np.ndarray] = None  # (3,) box half-sizes of g1 (box-box)
  size2: Optional[np.ndarray] = None  # (3,) box half-sizes of g2 (box kinds)
  corner: Optional[np.ndarray] = None  # (3,) +-1 corner (box corner kinds)
  owner: int = 0  # boxbox_corner: 1 = a corner of g1, 2 = a corner of g2
  condim: int = 3  # 1 = normal row only; 4/6 add torsional/rolling rows
  mu_tor: float = 0.0  # torsional friction coefficient (condim >= 4)
  mu_roll: float = 0.0  # rolling friction coefficient (condim 6)


@dataclasses.dataclass
class EqRow:
  """One active equality constraint: bilateral soft rows."""
  kind: int  # EqType value
  ob1: int  # body id (connect, weld) or joint id (joint coupling)
  ob2: int
  data: np.ndarray  # (11,) float32, MuJoCo's eq_data layout
  solref: np.ndarray  # (2,) float32
  solimp: np.ndarray  # (5,) float32
  # per-row softness scale: MuJoCo's diagApprox from invweight0, not the
  # live Delassus diagonal (a degenerate row's dual stays bounded)
  diagapprox: np.ndarray  # (nrows,) float32

  @property
  def nrows(self) -> int:
    return {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1}[
        EqType(self.kind)]


@dataclasses.dataclass
class TileModel:
  """Concrete (numpy) model constants for the supported class."""
  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  timestep: float
  gravity: np.ndarray  # (3,)
  body_parentid: tuple
  body_pos: np.ndarray
  body_quat: np.ndarray
  body_ipos: np.ndarray
  body_iquat: np.ndarray
  body_mass: np.ndarray
  body_inertia: np.ndarray
  jnt_type: tuple
  jnt_qposadr: tuple
  jnt_dofadr: tuple
  jnt_bodyid: tuple
  jnt_pos: np.ndarray
  jnt_axis: np.ndarray
  body_jntadr: tuple
  body_jntnum: tuple
  qpos0: np.ndarray
  dof_damping: np.ndarray
  dof_armature: np.ndarray
  dof_body_mask: np.ndarray  # (nv, nbody) bool
  dof_ancestor_mask: np.ndarray  # (nv, nv)
  cdofdot_vel_mask: np.ndarray  # (nv, nv): dofs whose vel rotates cdof[k]
  dof_body: tuple  # (nv,) body id of every dof
  body_mocapid: tuple  # (nbody,) -1 or mocap index (pose = an operand)
  nmocap: int
  nuserdata: int
  # actuators: scalar-joint transmission at (qadr, vadr), or a fixed
  # tendon's (act_tendon >= 0; its addresses are then 0)
  act_vadr: np.ndarray  # (nu,) dof index
  act_qadr: np.ndarray  # (nu,)
  act_gear: np.ndarray  # (nu,)
  act_gainprm: np.ndarray  # (nu, 3)
  act_biasprm: np.ndarray  # (nu, 3)
  act_gain_fixed: np.ndarray  # (nu,) bool
  act_bias_fixed: np.ndarray  # (nu,) bool
  ctrl_limited: np.ndarray  # (nu,) bool
  ctrl_lo: np.ndarray
  ctrl_hi: np.ndarray
  force_limited: np.ndarray
  force_lo: np.ndarray
  force_hi: np.ndarray
  # contacts: static candidate contact points
  con_points: tuple
  geom_bodyid: tuple
  geom_pos: np.ndarray
  geom_quat: np.ndarray
  # limits
  lim_jnt: tuple  # joint ids (two rows each: lo, hi)
  lim_qadr: tuple
  lim_vadr: tuple
  lim_lo: tuple
  lim_hi: tuple
  lim_margin: tuple
  lim_solref: np.ndarray  # (nlim_jnt, 2)
  # sites residuals read (StepView.site_xpos, site_xmat)
  site_bodyid: tuple
  site_pos: np.ndarray
  site_quat: np.ndarray
  # scalar-joint springs + smoothed Coulomb friction loss
  jnt_stiffness: np.ndarray  # (njnt,)
  qpos_spring: np.ndarray  # (nq,)
  dof_frictionloss: np.ndarray  # (nv,)
  # fixed tendons: per tendon ((qadr, vadr, coef), ...)
  ten_wraps: tuple = ()
  ten_stiffness: Optional[np.ndarray] = None  # (ntendon,)
  ten_damping: Optional[np.ndarray] = None  # (ntendon,)
  ten_lengthspring: Optional[np.ndarray] = None  # (ntendon, 2) deadband
  ten_lim: tuple = ()  # limited tendon ids (two rows each: lo, hi)
  ten_lim_range: Optional[np.ndarray] = None  # (nlimten, 2)
  ten_lim_margin: tuple = ()
  ten_lim_solref: Optional[np.ndarray] = None  # (nlimten, 2)
  act_tendon: tuple = ()  # (nu,) tendon id per actuator, -1 = scalar joint
  eq_rows: tuple = ()  # active equality constraints (EqRow), model order

  @property
  def ncon(self) -> int:
    return len(self.con_points)

  @property
  def ncon_rows(self) -> int:
    """Translational contact rows: 1 per condim-1 point, 3 otherwise."""
    return sum(1 if cp.condim == 1 else 3 for cp in self.con_points)

  @property
  def ntor(self) -> int:
    """Torsional rows: one per condim>=4 point."""
    return sum(1 for cp in self.con_points if cp.condim >= 4)

  @property
  def nroll(self) -> int:
    """Condim-6 points: two rolling rows each."""
    return sum(1 for cp in self.con_points if cp.condim >= 6)

  @property
  def nlim(self) -> int:
    return 2 * len(self.lim_jnt) + 2 * len(self.ten_lim)

  @property
  def neq_rows(self) -> int:
    return sum(e.nrows for e in self.eq_rows)

  @property
  def nrow(self) -> int:
    """Constraint rows: translational contact rows, torsional rows, 2 per
    rolling point, 2 per limited joint and limited tendon, then the
    equality rows."""
    return (self.ncon_rows + self.ntor + 2 * self.nroll + self.nlim
            + self.neq_rows)


def extract(m: Model) -> TileModel:
  """Concretize a Model into a TileModel; raises UnsupportedModel."""

  def npy(x):
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    # a float64 model's constants as float32 values: the kernel's model
    # struct holds floats in both precisions, and the plain version reads
    # some of them as Python floats
    return (a.astype(np.float32).astype(np.float64)
            if a.dtype == np.float64 else a)

  # the quaternion joints (ball, free) take no spring, limit, actuator,
  # tendon or joint equality: the JAX extract's refusals and reasons
  scalar = (JointType.HINGE, JointType.SLIDE)
  for j, jt in enumerate(m.jnt_type):
    if jt not in scalar + (JointType.BALL, JointType.FREE):
      _unsupported(f"joint type {jt}", _GENERAL)
    if jt not in scalar and float(npy(m.jnt_stiffness)[j]) != 0.0:
      _unsupported("spring on quaternion joint", _GENERAL)
  if m.na != 0:
    _unsupported("stateful actuators", _GENERAL)
  # mocap bodies: rollout-constant poses (kernel operands), as markers and
  # goals only
  mocap_bodies = {b for b in range(m.nbody) if m.body_mocapid[b] >= 0}
  for b in mocap_bodies:
    if m.body_jntnum[b]:
      _unsupported("jointed mocap body", _GENERAL)
  for g1, g2 in m.collision_pairs:
    if m.geom_bodyid[g1] in mocap_bodies or m.geom_bodyid[g2] in mocap_bodies:
      _unsupported("colliding mocap geom", _GENERAL)
  if m.opt.has_fluid:
    _unsupported("fluid forces", _GENERAL)
  # equality constraints: the active ones, each with its slice of the
  # model's per-row diagApprox (physics/io.py)
  eq_rows = []
  da_off = 0
  for e in range(len(m.eq_type)):
    if not m.eq_active0[e]:
      continue
    kind = EqType(m.eq_type[e])
    if kind == EqType.JOINT:
      for j in (m.eq_obj1id[e], m.eq_obj2id[e]):
        if j >= 0 and m.jnt_type[j] not in scalar:
          _unsupported("joint equality on quaternion joint", _GENERAL)
    row = EqRow(kind=int(kind), ob1=int(m.eq_obj1id[e]),
                ob2=int(m.eq_obj2id[e]),
                data=npy(m.eq_data)[e].astype(np.float32),
                solref=npy(m.eq_solref)[e].astype(np.float32),
                solimp=npy(m.eq_solimp)[e].astype(np.float32),
                diagapprox=np.zeros(0, np.float32))
    row.diagapprox = np.asarray(
        m.eq_diagapprox[da_off:da_off + row.nrows], np.float32)
    da_off += row.nrows
    eq_rows.append(row)
  # actuators: scalar-joint and fixed-tendon transmissions
  act_tendon = [-1] * m.nu
  for u in range(m.nu):
    if m.actuator_trntype[u] not in (TrnType.JOINT, TrnType.TENDON):
      _unsupported("site transmission", _GENERAL)
    if m.actuator_dyntype[u] != ActDyn.NONE:
      _unsupported("actuator dynamics", _GENERAL)
    if m.actuator_trntype[u] == TrnType.TENDON:
      act_tendon[u] = int(m.actuator_trnid[u])
    elif m.jnt_type[m.actuator_trnid[u]] not in scalar:
      _unsupported("actuator on quaternion joint", _GENERAL)

  # fixed tendons over scalar joints: constant Jacobian rows (limits,
  # springs and dampers, actuation)
  ten_wraps = []
  for wraps in m.tendon_joints:
    lst = []
    for jid, coef in wraps:
      if m.jnt_type[jid] not in scalar:
        _unsupported("tendon wrapping a quaternion joint", _GENERAL)
      # the coefficient at float32, as the kernel's model holds it
      lst.append((int(m.jnt_qposadr[jid]), int(m.jnt_dofadr[jid]),
                  float(np.float32(coef))))
    ten_wraps.append(tuple(lst))
  ten_lim = [t for t in range(m.ntendon) if m.tendon_limited[t]]

  # contacts: static pointwise expansion of the supported pairs
  con_points = []
  geom_xpos0, geom_xmat0 = _static_geom_frames(m)
  gs = npy(m.geom_size)
  fr = npy(m.geom_friction)
  # a pair's solref and solimp mixed whole from the geoms' float32 values
  # (pair_params rounds them for a float32 step)
  gsr, gsi = (npy(x).astype(np.float64) for x in (m.geom_solref,
                                                  m.geom_solimp))
  for g1, g2 in m.collision_pairs:
    t1, t2 = GeomType(m.geom_type[g1]), GeomType(m.geom_type[g2])
    b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
    condim = int(max(m.geom_condim[g1], m.geom_condim[g2]))
    common = dict(
        g1=g1, g2=g2, body1=b1, body2=b2,
        r1=float(gs[g1, 0]), r2=float(gs[g2, 0]),
        half1=float(gs[g1, 1]), half2=float(gs[g2, 1]),
        mu=float(max(fr[g1, 0], fr[g2, 0])),
        solref=0.5 * (gsr[g1] + gsr[g2]), solimp=0.5 * (gsi[g1] + gsi[g2]),
        margin=float(max(npy(m.geom_margin)[g1], npy(m.geom_margin)[g2])),
        condim=condim, mu_tor=float(max(fr[g1, 1], fr[g2, 1])),
        mu_roll=float(max(fr[g1, 2], fr[g2, 2])))
    if t1 == GeomType.PLANE and t2 in (GeomType.SPHERE, GeomType.CAPSULE,
                                       GeomType.CYLINDER, GeomType.BOX):
      if b1 != 0:
        _unsupported("plane on a moving body", _GENERAL)
      n = geom_xmat0[g1][:, 2]
      t1v = (np.array([1.0, 0, 0]) if abs(n[0]) < 0.5
             else np.array([0, 1.0, 0]))
      t1v = np.cross(n, t1v)
      t1v = t1v / np.linalg.norm(t1v)
      frame = np.stack([n, t1v, np.cross(n, t1v)]).astype(np.float32)
      plane = dict(sign=0.0, frame=frame, ppos=geom_xpos0[g1], **common)
      if t2 == GeomType.SPHERE:
        con_points.append(ConPoint(kind="plane_sphere", **plane))
      elif t2 == GeomType.BOX:  # collision._plane_box: the 8 corners
        for corner in itertools.product((-1.0, 1.0), repeat=3):
          con_points.append(ConPoint(
              kind="plane_boxcorner", size2=gs[g2].astype(np.float32),
              corner=np.asarray(corner, np.float32), **plane))
      else:
        for sgn in (-1.0, 1.0):
          con_points.append(ConPoint(kind="plane_capend",
                                     **{**plane, "sign": sgn}))
    elif (t1, t2) == (GeomType.SPHERE, GeomType.SPHERE):
      con_points.append(ConPoint(kind="sphere_sphere", sign=0.0, frame=None,
                                 ppos=None, **common))
    elif (t1, t2) == (GeomType.SPHERE, GeomType.CAPSULE):
      con_points.append(ConPoint(kind="sphere_cap", sign=0.0, frame=None,
                                 ppos=None, **common))
    elif (t1, t2) == (GeomType.SPHERE, GeomType.BOX):
      con_points.append(ConPoint(kind="sphere_box", sign=0.0, frame=None,
                                 ppos=None, size2=gs[g2].astype(np.float32),
                                 **common))
    elif (t1, t2) == (GeomType.CAPSULE, GeomType.CAPSULE):
      con_points.append(ConPoint(kind="cap_cap", sign=0.0, frame=None,
                                 ppos=None, **common))
    elif (t1, t2) == (GeomType.CAPSULE, GeomType.BOX):
      # collision._capsule_box: a sphere-box query at each capsule end
      for sgn in (-1.0, 1.0):
        con_points.append(ConPoint(kind="cap_box", sign=sgn, frame=None,
                                   ppos=None, size2=gs[g2].astype(np.float32),
                                   **common))
    elif (t1, t2) == (GeomType.BOX, GeomType.BOX):
      # collision._box_box: a face-SAT normal shared by 16 corner points,
      # box 2's corners first, each box's in sx, sy, sz loop order
      for owner in (2, 1):
        for corner in itertools.product((-1.0, 1.0), repeat=3):
          con_points.append(ConPoint(
              kind="boxbox_corner", sign=0.0, frame=None, ppos=None,
              size1=gs[g1].astype(np.float32),
              size2=gs[g2].astype(np.float32),
              corner=np.asarray(corner, np.float32), owner=owner, **common))
    else:
      _unsupported(f"contact pair {t1.name}/{t2.name}", _GENERAL)

  lim = [j for j in range(m.njnt) if m.jnt_limited[j]]
  for j in lim:
    if m.jnt_type[j] not in scalar:
      _unsupported("limit on quaternion joint", _GENERAL)
  jr = npy(m.jnt_range)
  dof_body = [0] * m.nv
  for j in range(m.njnt):
    ndof = {JointType.FREE: 6, JointType.BALL: 3}.get(m.jnt_type[j], 1)
    for i in range(ndof):
      dof_body[m.jnt_dofadr[j] + i] = m.jnt_bodyid[j]

  return TileModel(
      nq=m.nq, nv=m.nv, nu=m.nu, nbody=m.nbody, njnt=m.njnt,
      ngeom=m.ngeom, nsite=m.nsite,
      timestep=float(np.float32(float(m.opt.timestep))),
      gravity=npy(m.opt.gravity),
      body_parentid=tuple(m.body_parentid),
      body_pos=npy(m.body_pos), body_quat=npy(m.body_quat),
      body_ipos=npy(m.body_ipos), body_iquat=npy(m.body_iquat),
      body_mass=npy(m.body_mass), body_inertia=npy(m.body_inertia),
      jnt_type=tuple(m.jnt_type), jnt_qposadr=tuple(m.jnt_qposadr),
      jnt_dofadr=tuple(m.jnt_dofadr), jnt_bodyid=tuple(m.jnt_bodyid),
      jnt_pos=npy(m.jnt_pos), jnt_axis=npy(m.jnt_axis),
      body_jntadr=tuple(m.body_jntadr), body_jntnum=tuple(m.body_jntnum),
      qpos0=npy(m.qpos0),
      dof_damping=npy(m.dof_damping), dof_armature=npy(m.dof_armature),
      dof_body_mask=npy(m.dof_body_mask),
      dof_ancestor_mask=npy(m.dof_ancestor_mask),
      cdofdot_vel_mask=npy(m.cdofdot_vel_mask),
      dof_body=tuple(dof_body),
      body_mocapid=tuple(int(x) for x in m.body_mocapid),
      nmocap=int(m.nmocap), nuserdata=int(m.nuserdata),
      act_vadr=np.asarray([0 if act_tendon[u] >= 0
                           else m.jnt_dofadr[m.actuator_trnid[u]]
                           for u in range(m.nu)], np.int32),
      act_qadr=np.asarray([0 if act_tendon[u] >= 0
                           else m.jnt_qposadr[m.actuator_trnid[u]]
                           for u in range(m.nu)], np.int32),
      act_gear=npy(m.actuator_gear)[:, 0] if m.nu else np.zeros(0),
      act_gainprm=npy(m.actuator_gainprm),
      act_biasprm=npy(m.actuator_biasprm),
      act_gain_fixed=np.asarray(
          [t == GainBias.FIXED for t in m.actuator_gaintype]),
      act_bias_fixed=np.asarray(
          [t == GainBias.FIXED for t in m.actuator_biastype]),
      ctrl_limited=npy(m.actuator_ctrllimited),
      ctrl_lo=npy(m.actuator_ctrlrange)[:, 0] if m.nu else np.zeros(0),
      ctrl_hi=npy(m.actuator_ctrlrange)[:, 1] if m.nu else np.zeros(0),
      force_limited=npy(m.actuator_forcelimited),
      force_lo=npy(m.actuator_forcerange)[:, 0] if m.nu else np.zeros(0),
      force_hi=npy(m.actuator_forcerange)[:, 1] if m.nu else np.zeros(0),
      con_points=tuple(con_points),
      geom_bodyid=tuple(m.geom_bodyid),
      geom_pos=npy(m.geom_pos), geom_quat=npy(m.geom_quat),
      lim_jnt=tuple(lim),
      lim_qadr=tuple(m.jnt_qposadr[j] for j in lim),
      lim_vadr=tuple(m.jnt_dofadr[j] for j in lim),
      lim_lo=tuple(float(jr[j, 0]) for j in lim),
      lim_hi=tuple(float(jr[j, 1]) for j in lim),
      lim_margin=tuple(float(npy(m.jnt_margin)[j]) for j in lim),
      lim_solref=(np.stack([npy(m.jnt_solref)[j] for j in lim])
                  if lim else np.zeros((0, 2))),
      site_bodyid=tuple(m.site_bodyid), site_pos=npy(m.site_pos),
      site_quat=npy(m.site_quat),
      jnt_stiffness=npy(m.jnt_stiffness),
      qpos_spring=npy(m.qpos_spring),
      dof_frictionloss=npy(m.dof_frictionloss),
      ten_wraps=tuple(ten_wraps),
      ten_stiffness=(npy(m.tendon_stiffness) if m.ntendon
                     else np.zeros(0)),
      ten_damping=npy(m.tendon_damping) if m.ntendon else np.zeros(0),
      ten_lengthspring=(npy(m.tendon_lengthspring) if m.ntendon
                        else np.zeros((0, 2))),
      ten_lim=tuple(ten_lim),
      ten_lim_range=(np.stack([npy(m.tendon_range)[t] for t in ten_lim])
                     if ten_lim else np.zeros((0, 2))),
      ten_lim_margin=tuple(float(npy(m.tendon_margin)[t])
                           for t in ten_lim),
      ten_lim_solref=(np.stack([npy(m.tendon_solref_lim)[t]
                                for t in ten_lim])
                      if ten_lim else np.zeros((0, 2))),
      act_tendon=tuple(act_tendon),
      eq_rows=tuple(eq_rows),
  )


def row_points(tm: TileModel) -> Tuple[tuple, tuple, tuple, tuple]:
  """Contact points in row order: the condim>=3 points (three rows each),
  the condim-1 points (one row each), then the condim>=4 points again (one
  torsional row each) and the condim-6 points (two rolling rows each, all
  the first-tangent rows before the second-tangent ones), each in the
  order of the first group."""
  return (tuple(cp for cp in tm.con_points if cp.condim >= 3),
          tuple(cp for cp in tm.con_points if cp.condim == 1),
          tuple(cp for cp in tm.con_points if cp.condim >= 4),
          tuple(cp for cp in tm.con_points if cp.condim >= 6))


_EQ_KIND = {EqType.JOINT: "eq_joint", EqType.CONNECT: "eq_connect",
            EqType.WELD: "eq_weld"}


def row_kinds(tm: TileModel) -> Tuple[str, ...]:
  """The class of every constraint row, in the tile layout: the contact
  kind ('plane_capend', 'plane_sphere', 'plane_boxcorner', 'sphere_sphere',
  'sphere_cap', 'sphere_box', 'cap_cap', 'cap_box', 'boxbox_corner'),
  'torsional', 'rolling', 'joint_limit', 'tendon_limit', 'eq_joint',
  'eq_connect' or 'eq_weld'."""
  fric, ones, tor, roll = row_points(tm)
  kinds = [cp.kind for cp in fric for _ in range(3)]
  kinds += [cp.kind for cp in ones]
  kinds += ["torsional"] * len(tor)
  kinds += ["rolling"] * (2 * len(roll))
  kinds += ["joint_limit"] * (2 * len(tm.lim_jnt))
  kinds += ["tendon_limit"] * (2 * len(tm.ten_lim))
  for er in tm.eq_rows:
    kinds += [_EQ_KIND[EqType(er.kind)]] * er.nrows
  return tuple(kinds)


def _static_geom_frames(m: Model):
  """World pose of geoms on the world body (numpy, build time)."""
  gpos = m.geom_pos.detach().cpu().numpy()
  gquat = m.geom_quat.detach().cpu().numpy()
  xpos = {g: gpos[g] for g in range(m.ngeom)}
  xmat = {}
  for g in range(m.ngeom):
    w, x, y, z = gquat[g]
    xmat[g] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
  return xpos, xmat


def impedance_consts(solimp) -> Tuple[float, float, float, float, float]:
  """(d0, d1, width, mid, power) of a constant solimp, clamped as in
  _impedance."""
  d0, d1, width, mid, power = (float(v) for v in np.asarray(solimp)[:5])
  return (d0, d1, max(width, 1e-12), min(max(mid, 1e-4), 1 - 1e-4),
          max(power, 1.0))


def pair_params(cp: ConPoint, dtype):
  """A contact point's (solref, solimp) at the step's precision: the
  mixture whole in a float64 step, as a float64 model mixes the geoms'
  values, and rounded to float32 in a float32 step, as a float32 model
  mixes them."""
  npd = np.float64 if dtype == torch.float64 else np.float32
  return cp.solref.astype(npd), cp.solimp.astype(npd)


def kb(solref, dmax: float) -> Tuple[float, float]:
  """Constant stiffness/damping from constant solref (solver.py:_kb)."""
  solref = np.asarray(solref)
  tc, dr = max(float(solref[0]), 1e-8), max(float(solref[1]), 1e-8)
  if solref[0] <= 0 and solref[1] <= 0:
    return -float(solref[0]) / dmax ** 2, -float(solref[1]) / dmax
  return 1.0 / (dmax * dmax * tc * tc * dr * dr), 2.0 / (dmax * tc)


# ---------------------------------------------------------------------------
# tile math: component-leading, batch-trailing
# ---------------------------------------------------------------------------


def _c(v):
  """Model constant as Python floats of its float32 value."""
  return [float(x) for x in np.asarray(v, dtype=np.float32).ravel()]


def _quat_mul(q1, q2):
  """(4, B) x (4, B) -> (4, B); either may be a list of 4 floats."""
  w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
  w2, x2, y2, z2 = q2[0], q2[1], q2[2], q2[3]
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ])


def _cross(a, b):
  return torch.stack([
      a[1] * b[2] - a[2] * b[1],
      a[2] * b[0] - a[0] * b[2],
      a[0] * b[1] - a[1] * b[0],
  ])


def _quat_rot(q, v):
  """Rotate v (3 floats or (3, B)) by quaternion q (4, B)."""
  w = q[0]
  u = q[1:]
  uv = _cross(u, v)
  uuv = _cross(u, uv)
  return torch.stack([v[k] + 2.0 * (w * uv[k] + uuv[k]) for k in range(3)])


def _dot3(a, b):
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _quat_to_mat(q):
  """(4, B) -> (3, 3, B)."""
  w, x, y, z = q[0], q[1], q[2], q[3]
  return torch.stack([
      torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
      torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
      torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]),
  ])


def _quat_normalize(q):
  inv = 1.0 / torch.sqrt(torch.clamp(
      q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], min=1e-24))
  return torch.stack([q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv])


def _quat_integrate(q, w0, w1, w2, dt: float):
  """q (4, B) advanced by the exact exponential of the body-frame angular
  velocity (w0, w1, w2) over dt, NaN-free at w = 0, then normalized."""
  sq = w0 * w0 + w1 * w1 + w2 * w2
  small = sq < 1e-24
  theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
  inv = 1.0 / theta
  half = 0.5 * theta * dt
  s = torch.sin(half) * inv
  zero = torch.zeros_like(sq)
  dq = torch.stack([torch.where(small, zero + 1.0, torch.cos(half)),
                    torch.where(small, zero, w0 * s),
                    torch.where(small, zero, w1 * s),
                    torch.where(small, zero, w2 * s)])
  return _quat_normalize(_quat_mul(q, dq))


def _axis_angle_quat(axis, angle):
  """3 axis floats + (B,) angle -> (4, B) quaternion."""
  half = 0.5 * angle
  s = torch.sin(half)
  return torch.stack([torch.cos(half), axis[0] * s, axis[1] * s,
                      axis[2] * s])


def _chol_factor(a, eps=1e-12):
  """Cholesky of a (B, n, n) SPD batch, pivots clamped at eps."""
  n = a.shape[-1]
  low = torch.zeros_like(a)
  for j in range(n):
    s = a[:, j, j] - torch.sum(low[:, j, :j] * low[:, j, :j], dim=-1)
    ljj = torch.sqrt(torch.clamp(s, min=eps))
    low[:, j, j] = ljj
    if j + 1 < n:
      r = a[:, j + 1:, j] - torch.sum(
          low[:, j + 1:, :j] * low[:, j:j + 1, :j], dim=-1)
      low[:, j + 1:, j] = r * (1.0 / ljj)[:, None]
  return low


def _chol_solve(low, rhs):
  """Solve L L^T x = rhs for rhs (n, B) or (n, R, B); low (B, n, n)."""
  if rhs.dim() == 2:
    x = rhs.T.unsqueeze(-1)  # (B, n, 1)
  else:
    x = rhs.permute(2, 0, 1)  # (B, n, R)
  y = torch.linalg.solve_triangular(low, x, upper=False)
  x = torch.linalg.solve_triangular(low.mT, y, upper=True)
  return x.squeeze(-1).T if rhs.dim() == 2 else x.permute(1, 2, 0)


def _impedance(pos, d0, d1, width, mid, power):
  """MuJoCo impedance sigmoid; the constants may be (rows, 1) tensors."""
  x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
  y_lo = torch.pow(x / mid, power) * mid
  y_hi = 1.0 - torch.pow((1 - x) / (1 - mid), power) * (1 - mid)
  y = torch.where(x < mid, y_lo, y_hi)
  return torch.clamp(d0 + y * (d1 - d0), _MINIMP, _MAXIMP)


@dataclasses.dataclass
class ContactView:
  """The step's contact points as a residual reads them, in the order of
  TileModel.con_points (pre-step geometry, the margin taken off dist)."""
  dist: torch.Tensor  # (ncon, B)
  frame: torch.Tensor  # (ncon, 3, 3, B): rows n, t1, t2
  pairs: tuple  # (ncon,) geom pair (g1, g2) of each point; n points g1->g2
  # (ncon, 3, B) the step's converged force in each point's frame (normal,
  # t1, t2; a condim-1 point's tangents 0), as the general step's
  # Contact.force; set by step_tb after the solve
  force: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StepView:
  """What a task residual reads after a step (component-leading,
  batch-trailing). Frames are PRE-step (the state the step started from),
  qpos/qvel are POST-step -- the convention of the JAX tile path. The
  rollout-constant operands (mocap poses, userdata) have a trailing axis of
  1 that broadcasts against the batch. `contact`, a ContactView, is set by
  step_tb on a model with contact points (None otherwise); it is not a
  field, as it is not one of the JAX view's arrays."""
  contact = None
  qpos: torch.Tensor  # (nq, B) post-step
  qvel: torch.Tensor  # (nv, B) post-step
  ctrl: torch.Tensor  # (nu, B) as given, before clamping
  xpos: torch.Tensor  # (nbody, 3, B)
  xquat: torch.Tensor  # (nbody, 4, B)
  xmat: torch.Tensor  # (nbody, 3, 3, B)
  xipos: torch.Tensor  # (nbody, 3, B)
  ximat: torch.Tensor  # (nbody, 3, 3, B)
  cvel: torch.Tensor  # (nbody, 6, B)
  subtree_com: torch.Tensor  # (nbody, 3, B)
  site_xpos: torch.Tensor  # (nsite, 3, B)
  site_xmat: torch.Tensor  # (nsite, 3, 3, B)
  geom_xpos: torch.Tensor  # (ngeom, 3, B)
  actuator_force: torch.Tensor  # (nu, B) of the clamped ctrl
  mocap_pos: torch.Tensor  # (nmocap, 3, 1)
  mocap_quat: torch.Tensor  # (nmocap, 4, 1)
  userdata: torch.Tensor  # (nuserdata, 1)
  efc_lambda: torch.Tensor  # (nrow, B) converged duals
  time: Optional[torch.Tensor] = None


def aux_operands(tm: TileModel, mocap_pos=None, mocap_quat=None,
                 userdata=None, dtype=torch.float32, device="cpu"):
  """The rollout-constant operands shaped (nmocap, 3, 1), (nmocap, 4, 1)
  and (nuserdata, 1), never empty: zeros, identity quaternions and zeros
  where not given (mujoco_mpc_tpu MegaRollout._aux_operands)."""
  nmc, nud = max(tm.nmocap, 1), max(tm.nuserdata, 1)

  def given(x):
    return x is not None and torch.as_tensor(x).numel() > 0

  def t(x, n):
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(n)

  mp = t(mocap_pos, (nmc, 3)) if given(mocap_pos) else torch.zeros(
      (nmc, 3), dtype=dtype, device=device)
  mq = t(mocap_quat, (nmc, 4)) if given(mocap_quat) else torch.tensor(
      [[1.0, 0.0, 0.0, 0.0]] * nmc, dtype=dtype, device=device)
  ud = t(userdata, (nud,)) if given(userdata) else torch.zeros(
      (nud,), dtype=dtype, device=device)
  return mp[..., None], mq[..., None], ud[:, None]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def step_tb(tm: TileModel, qpos, qvel, ctrl, efc_lambda=None, *,
            mocap_pos=None, mocap_quat=None, userdata=None):
  """One physics step in tile layout (plain PyTorch).

  Args: qpos (nq, B); qvel (nv, B); ctrl (nu, B); efc_lambda (nrow, B)
  warm-start duals (None or all-zero columns = cold start); the
  rollout-constant mocap poses and userdata, as `aux_operands` takes them
  (None: its defaults). A mocap body's pose overrides its kinematics.
  Returns (qpos2, qvel2, view) with view a StepView.
  """
  nv, nbody = tm.nv, tm.nbody
  h = tm.timestep
  B = qpos.shape[1]
  dtype, dev = qpos.dtype, qpos.device
  zero = torch.zeros_like(qpos[0])
  zero3 = torch.stack([zero, zero, zero])

  def const(v):
    """A constant as a tensor at the step's precision: the model's float32
    values as they are, one derived from them (a row's impedance,
    stiffness and damping) rounded only in a float32 step."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                           device=dev)

  mocap_pos, mocap_quat, userdata = aux_operands(
      tm, mocap_pos, mocap_quat, userdata, dtype, dev)

  # ---- forward kinematics
  xpos = [zero3]
  xquat = [torch.stack([zero + 1.0, zero, zero, zero])]
  xanchor = [None] * tm.njnt
  xaxis = [None] * tm.njnt
  for bd in range(1, nbody):
    p = tm.body_parentid[bd]
    quat = _quat_mul(xquat[p], _c(tm.body_quat[bd]))
    pos = xpos[p] + _quat_rot(xquat[p], _c(tm.body_pos[bd]))
    mid = tm.body_mocapid[bd]
    if mid >= 0:  # the mocap pose overrides (rollout-constant)
      pos = torch.stack([zero + mocap_pos[mid, i] for i in range(3)])
      quat = torch.stack([zero + mocap_quat[mid, i] for i in range(4)])
    jadr, jnum = tm.body_jntadr[bd], tm.body_jntnum[bd]
    for j in range(jadr, jadr + jnum):
      qadr = tm.jnt_qposadr[j]
      ax = _c(tm.jnt_axis[j])
      jp = _c(tm.jnt_pos[j])
      if tm.jnt_type[j] == JointType.FREE:
        pos = qpos[qadr:qadr + 3]
        quat = _quat_normalize(qpos[qadr + 3:qadr + 7])
        xanchor[j] = pos
        xaxis[j] = _quat_rot(quat, ax)
        continue
      anchor = pos + _quat_rot(quat, jp)
      if tm.jnt_type[j] == JointType.BALL:
        # the local rotation normalized; no qpos0 offset, unlike a hinge
        quat = _quat_mul(quat, _quat_normalize(qpos[qadr:qadr + 4]))
        pos = anchor - _quat_rot(quat, jp)
      elif tm.jnt_type[j] == JointType.SLIDE:
        pos = pos + _quat_rot(quat, ax) * (
            qpos[qadr] - float(tm.qpos0[qadr]))
      else:  # HINGE
        angle = qpos[qadr] - float(tm.qpos0[qadr])
        quat = _quat_mul(quat, _axis_angle_quat(ax, angle))
        pos = anchor - _quat_rot(quat, jp)
      xanchor[j] = anchor
      xaxis[j] = _quat_rot(quat, ax)
    xpos.append(pos)
    xquat.append(quat)

  xmat = [_quat_to_mat(q) for q in xquat]
  xipos = [xpos[bd] + _quat_rot(xquat[bd], _c(tm.body_ipos[bd]))
           for bd in range(nbody)]
  ximat = [_quat_to_mat(_quat_mul(xquat[bd], _c(tm.body_iquat[bd])))
           for bd in range(nbody)]

  # ---- cdof (world-origin motion subspace) per dof; a free joint's
  #      translations are the world axes, its rotations the body axes
  #      (xmat columns) about xpos; a ball joint's rotations the body axes
  #      about its anchor
  cdof = [None] * nv
  for j in range(tm.njnt):
    k0 = tm.jnt_dofadr[j]
    if tm.jnt_type[j] == JointType.SLIDE:
      cdof[k0] = (zero3, xaxis[j])
    elif tm.jnt_type[j] == JointType.HINGE:
      cdof[k0] = (xaxis[j], _cross(xanchor[j], xaxis[j]))
    else:  # BALL, FREE
      bd = tm.jnt_bodyid[j]
      rot0, origin = k0, xanchor[j]
      if tm.jnt_type[j] == JointType.FREE:
        for i in range(3):
          cdof[k0 + i] = (zero3, torch.stack(
              [zero + 1.0 if c == i else zero for c in range(3)]))
        rot0, origin = k0 + 3, xpos[bd]
      for i in range(3):
        ang = xmat[bd][:, i]
        cdof[rot0 + i] = (ang, _cross(origin, ang))

  # ---- body spatial velocities + cdof_dot (static masks)
  contrib = [(cdof[k][0] * qvel[k], cdof[k][1] * qvel[k]) for k in range(nv)]

  def _msum(ks, comp):
    if not ks:
      return zero3
    acc = contrib[ks[0]][comp]
    for k in ks[1:]:
      acc = acc + contrib[k][comp]
    return acc

  cvel = []
  for bd in range(nbody):
    ks = [k for k in range(nv) if tm.dof_body_mask[k, bd]]
    cvel.append((_msum(ks, 0), _msum(ks, 1)))
  cdof_dot = []
  for k in range(nv):
    ks = [i for i in range(nv) if tm.cdofdot_vel_mask[k, i]]
    va, vl = _msum(ks, 0), _msum(ks, 1)
    ca, cl = cdof[k]
    cdof_dot.append((_cross(va, ca), _cross(va, cl) + _cross(vl, ca)))

  dof_of_body = [[] for _ in range(nbody)]
  for k in range(nv):
    dof_of_body[tm.dof_body[k]].append(k)

  # ---- spatial inertia about the world origin per body
  ibody = []  # (Iw (3,3,B), com (3,B), mass float)
  for bd in range(nbody):
    R = ximat[bd]
    idiag = _c(tm.body_inertia[bd])
    Iw = torch.stack([
        torch.stack([sum(R[i, k] * idiag[k] * R[jj, k] for k in range(3))
                     for jj in range(3)]) for i in range(3)])
    ibody.append((Iw, xipos[bd], float(tm.body_mass[bd])))

  def inert_mul(Iw, com, mass, va, vl):
    ang = (torch.stack([sum(Iw[i, k] * va[k] for k in range(3))
                        for i in range(3)])
           - mass * _cross(com, _cross(com, va)) + mass * _cross(com, vl))
    lin = -mass * _cross(com, va) + mass * vl
    return ang, lin

  # ---- CRB: composite inertias
  comp_mc = [ibody[bd][2] * ibody[bd][1] for bd in range(nbody)]
  comp_m = [ibody[bd][2] for bd in range(nbody)]

  def topleft(Iw, com, mass):
    cx, cy, cz = com[0], com[1], com[2]
    cc = torch.stack([
        torch.stack([cy * cy + cz * cz, -cx * cy, -cx * cz]),
        torch.stack([-cx * cy, cx * cx + cz * cz, -cy * cz]),
        torch.stack([-cx * cz, -cy * cz, cx * cx + cy * cy]),
    ])
    return Iw + mass * cc

  comp_TL = [topleft(*ibody[bd]) for bd in range(nbody)]
  for bd in range(nbody - 1, 0, -1):
    p = tm.body_parentid[bd]
    if p > 0:
      comp_TL[p] = comp_TL[p] + comp_TL[bd]
      comp_mc[p] = comp_mc[p] + comp_mc[bd]
      comp_m[p] = comp_m[p] + comp_m[bd]

  def comp_mul(bd, va, vl):
    TL, mc, mm = comp_TL[bd], comp_mc[bd], comp_m[bd]
    ang = (torch.stack([sum(TL[i, k] * va[k] for k in range(3))
                        for i in range(3)]) + _cross(mc, vl))
    lin = -_cross(mc, va) + mm * vl
    return ang, lin

  dof_body = tm.dof_body
  f_dof = [comp_mul(dof_body[j], cdof[j][0], cdof[j][1]) for j in range(nv)]
  anc = tm.dof_ancestor_mask
  qM = {}  # upper-triangular entries on the ancestor sparsity
  for j in range(nv):
    fa, fl = f_dof[j]
    for i in range(j + 1):
      if anc[i, j]:
        qM[(i, j)] = _dot3(cdof[i][0], fa) + _dot3(cdof[i][1], fl)

  # ---- RNE bias (qacc = 0, base acceleration = -gravity)
  g = _c(tm.gravity)
  cacc = [(zero3, torch.stack([zero - g[0], zero - g[1], zero - g[2]]))]
  for bd in range(1, nbody):
    aa, al = cacc[tm.body_parentid[bd]]
    for k in dof_of_body[bd]:
      da, dl = cdof_dot[k]
      aa = aa + da * qvel[k]
      al = al + dl * qvel[k]
    cacc.append((aa, al))
  cfa, cfl = [], []
  for bd in range(nbody):
    Iw, com, mass = ibody[bd]
    va, vl = cvel[bd]
    fa_v, fl_v = inert_mul(Iw, com, mass, va, vl)
    fa_a, fl_a = inert_mul(Iw, com, mass, *cacc[bd])
    cfa.append(fa_a + _cross(va, fa_v) + _cross(vl, fl_v))
    cfl.append(fl_a + _cross(va, fl_v))
  for bd in range(nbody - 1, 0, -1):
    p = tm.body_parentid[bd]
    cfa[p] = cfa[p] + cfa[bd]
    cfl[p] = cfl[p] + cfl[bd]
  qfrc_bias = [_dot3(cdof[k][0], cfa[dof_body[k]])
               + _dot3(cdof[k][1], cfl[dof_body[k]]) for k in range(nv)]

  # ---- passive forces + actuation
  qfrc_passive = [-float(tm.dof_damping[k]) * qvel[k] for k in range(nv)]
  for k in range(nv):
    fl = float(tm.dof_frictionloss[k])
    if fl != 0.0:
      qfrc_passive[k] = qfrc_passive[k] - fl * torch.tanh(qvel[k] / 0.01)
  for j in range(tm.njnt):
    ks = float(tm.jnt_stiffness[j])
    if ks != 0.0 and tm.jnt_type[j] != JointType.FREE:
      qadr, vadr = tm.jnt_qposadr[j], tm.jnt_dofadr[j]
      qfrc_passive[vadr] = qfrc_passive[vadr] - ks * (
          qpos[qadr] - float(tm.qpos_spring[qadr]))

  # fixed tendons: length and velocity memoised per tendon (springs and
  # dampers, actuators)
  ten_memo = {}

  def tendon_len_vel(t):
    if t not in ten_memo:
      ln = vl = None
      for qadr, vadr, coef in tm.ten_wraps[t]:
        lt, vt = coef * qpos[qadr], coef * qvel[vadr]
        ln = lt if ln is None else ln + lt
        vl = vt if vl is None else vl + vt
      ten_memo[t] = (ln, vl)
    return ten_memo[t]

  # tendon spring (deadband about lengthspring) and damper, through the
  # tendon's constant Jacobian
  for t, wraps in enumerate(tm.ten_wraps):
    k_t, c_t = float(tm.ten_stiffness[t]), float(tm.ten_damping[t])
    if k_t == 0.0 and c_t == 0.0:
      continue
    ln, vl = tendon_len_vel(t)
    lo, hi = (float(x) for x in tm.ten_lengthspring[t])
    stretch = torch.where(ln > hi, ln - hi,
                          torch.where(ln < lo, ln - lo, torch.zeros_like(ln)))
    f_t = -k_t * stretch - c_t * vl
    for _, vadr, coef in wraps:
      qfrc_passive[vadr] = qfrc_passive[vadr] + coef * f_t

  qfrc_act = [zero for _ in range(nv)]
  act_force = []
  for u in range(tm.nu):
    c = ctrl[u]
    if tm.ctrl_limited[u]:
      c = torch.clamp(c, float(tm.ctrl_lo[u]), float(tm.ctrl_hi[u]))
    gear = float(tm.act_gear[u])
    tid = tm.act_tendon[u]
    if tid >= 0:  # fixed-tendon transmission
      ln, vl = tendon_len_vel(tid)
      length, velocity = gear * ln, gear * vl
    else:
      length = gear * qpos[int(tm.act_qadr[u])]
      velocity = gear * qvel[int(tm.act_vadr[u])]
    gp = tm.act_gainprm[u]
    if tm.act_gain_fixed[u]:
      gain = float(gp[0])
    else:
      gain = float(gp[0]) + float(gp[1]) * length + float(gp[2]) * velocity
    bp = tm.act_biasprm[u]
    if tm.act_bias_fixed[u]:
      bias = 0.0
    else:
      bias = float(bp[0]) + float(bp[1]) * length + float(bp[2]) * velocity
    force = gain * c + bias
    if tm.force_limited[u]:
      force = torch.clamp(force, float(tm.force_lo[u]),
                          float(tm.force_hi[u]))
    act_force.append(force)
    if tid >= 0:  # moment: gear times the tendon's coefficients
      for _, vadr, coef in tm.ten_wraps[tid]:
        qfrc_act[vadr] = qfrc_act[vadr] + gear * coef * force
    else:
      k = int(tm.act_vadr[u])
      qfrc_act[k] = qfrc_act[k] + gear * force

  # ---- implicit-damping inertia factor
  amat_m = torch.zeros((B, nv, nv), dtype=dtype, device=dev)
  for (i, j), v in qM.items():
    amat_m[:, i, j] = v
    amat_m[:, j, i] = v
  for k in range(nv):
    amat_m[:, k, k] = (amat_m[:, k, k] + float(tm.dof_armature[k])
                       + h * float(tm.dof_damping[k]))
  L = _chol_factor(amat_m)

  qfrc_smooth = torch.stack([qfrc_passive[k] + qfrc_act[k] - qfrc_bias[k]
                             for k in range(nv)])
  qacc_smooth = _chol_solve(L, qfrc_smooth)

  # ---- contacts + limits -> constraint solve
  nrow = tm.nrow
  contact = None
  if nrow:
    f, lam_out, contact = _constraint_solve(tm, qpos, qvel, xpos, xquat,
                                            cdof, L, qacc_smooth, efc_lambda,
                                            const)
    qfrc_constraint = f
    contact.force = _contact_force(tm, lam_out)
  else:
    qfrc_constraint = torch.zeros_like(qfrc_smooth)
    lam_out = (torch.zeros((1, B), dtype=dtype, device=dev)
               if efc_lambda is None else efc_lambda)

  # ---- integrate (semi-implicit Euler, implicit damping in the factor);
  #      a free or ball joint's quaternion by the exact exponential map
  qacc = _chol_solve(L, qfrc_smooth + qfrc_constraint)
  qvel2 = qvel + h * qacc
  out_q = [None] * tm.nq
  for j in range(tm.njnt):
    qadr, vadr = tm.jnt_qposadr[j], tm.jnt_dofadr[j]
    if tm.jnt_type[j] == JointType.FREE:
      for i in range(3):
        out_q[qadr + i] = qpos[qadr + i] + h * qvel2[vadr + i]
      quat = _quat_integrate(qpos[qadr + 3:qadr + 7], qvel2[vadr + 3],
                             qvel2[vadr + 4], qvel2[vadr + 5], h)
      for i in range(4):
        out_q[qadr + 3 + i] = quat[i]
    elif tm.jnt_type[j] == JointType.BALL:
      quat = _quat_integrate(qpos[qadr:qadr + 4], qvel2[vadr],
                             qvel2[vadr + 1], qvel2[vadr + 2], h)
      for i in range(4):
        out_q[qadr + i] = quat[i]
    else:
      out_q[qadr] = qpos[qadr] + h * qvel2[vadr]
  qpos2 = torch.stack(out_q)

  # subtree CoM: comp_mc / comp_m are the subtree sums after the CRB pass;
  # body 0 is the whole system
  root_mc, root_m = comp_mc[0], comp_m[0]
  for bd in range(1, nbody):
    if tm.body_parentid[bd] == 0:
      root_mc = root_mc + comp_mc[bd]
      root_m = root_m + comp_m[bd]
  sub_com = [root_mc / max(root_m, 1e-12)] + [
      comp_mc[bd] / max(comp_m[bd], 1e-12) for bd in range(1, nbody)]

  # site and geom centres (pre-step frames)
  def points(bodies, pos):
    out = [xpos[b] + _quat_rot(xquat[b], _c(pos[i]))
           for i, b in enumerate(bodies)]
    return (torch.stack(out) if out
            else torch.zeros((0, 3, B), dtype=dtype, device=dev))

  site_xmat = [_quat_to_mat(_quat_mul(xquat[b], _c(tm.site_quat[i])))
               for i, b in enumerate(tm.site_bodyid)]
  view = StepView(
      qpos=qpos2, qvel=qvel2, ctrl=ctrl,
      xpos=torch.stack(xpos), xquat=torch.stack(xquat),
      xmat=torch.stack(xmat), xipos=torch.stack(xipos),
      ximat=torch.stack(ximat),
      cvel=torch.stack([torch.cat([va, vl]) for va, vl in cvel]),
      subtree_com=torch.stack(sub_com),
      site_xpos=points(tm.site_bodyid, tm.site_pos),
      site_xmat=(torch.stack(site_xmat) if site_xmat
                 else torch.zeros((0, 3, 3, B), dtype=dtype, device=dev)),
      geom_xpos=points(tm.geom_bodyid, tm.geom_pos),
      actuator_force=(torch.stack(act_force) if act_force
                      else torch.zeros((0, B), dtype=dtype, device=dev)),
      mocap_pos=mocap_pos, mocap_quat=mocap_quat, userdata=userdata,
      efc_lambda=lam_out)
  view.contact = contact
  return qpos2, qvel2, view


def _contact_force(tm, lam):
  """Each contact point's force (ncon, 3, B) in its frame from the
  converged duals `lam` (nrow, B), in the order of tm.con_points: a
  condim>=3 point's three rows, a condim-1 point's normal row and two
  zeros."""
  fric, ones, _, _ = row_points(tm)
  rows = {id(cp): [3 * k, 3 * k + 1, 3 * k + 2] for k, cp in enumerate(fric)}
  zero = lam.shape[0]  # the row of zeros appended below
  rows.update({id(cp): [3 * len(fric) + k, zero, zero]
               for k, cp in enumerate(ones)})
  idx = np.asarray([rows[id(cp)] for cp in tm.con_points],
                   np.int64).reshape(-1, 3)
  padded = torch.cat([lam, torch.zeros_like(lam[:1])])
  return padded[torch.as_tensor(idx, device=lam.device)]


def _frame_from_normal(n):
  """Contact frame rows (n, t1, t2) from a unit normal (3, B)
  (collision._frame_from_normal)."""
  use_x = torch.abs(n[0]) < 0.5
  one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
  ref = torch.stack([torch.where(use_x, one, zero),
                     torch.where(use_x, zero, one), zero])
  t1 = _cross(n, ref)
  t1 = t1 / torch.sqrt(torch.clamp(_dot3(t1, t1), min=1e-24))
  return torch.stack([n, t1, _cross(n, t1)])


def _mat_vec(m, v):
  """(3, 3, B) matrix times 3 floats or (3, B), summed in index order."""
  return torch.stack([m[i, 0] * v[0] + m[i, 1] * v[1] + m[i, 2] * v[2]
                      for i in range(3)])


def _mat_tvec(m, v):
  """The transpose of (3, 3, B) times (3, B)."""
  return torch.stack([m[0, i] * v[0] + m[1, i] * v[1] + m[2, i] * v[2]
                      for i in range(3)])


def _sphere_box_point(center, radius, bp, bm, bsize):
  """(dist, contact position, normal from the sphere into the box) of a
  sphere against a box of half-sizes bsize at (bp, bm)
  (collision._sphere_box_point; argmin as first-min one-hot selects)."""
  local = _mat_tvec(bm, center - bp)
  s = [float(x) for x in bsize]
  absl = [torch.abs(local[i]) for i in range(3)]
  clamped = [torch.clamp(local[i], -s[i], s[i]) for i in range(3)]
  inside = (absl[0] < s[0]) & (absl[1] < s[1]) & (absl[2] < s[2])
  fd = [s[i] - absl[i] for i in range(3)]
  is0 = (fd[0] <= fd[1]) & (fd[0] <= fd[2])
  is1 = ~is0 & (fd[1] <= fd[2])
  is_k = [is0, is1, ~(is0 | is1)]
  sgn = [torch.sign(local[i]) for i in range(3)]
  surf = torch.stack([
      torch.where(inside, torch.where(is_k[i], sgn[i] * s[i], local[i]),
                  clamped[i]) for i in range(3)])
  world = bp + _mat_vec(bm, surf)
  delta = center - world
  dn = torch.sqrt(torch.clamp(_dot3(delta, delta), min=0.0))
  inv = 1.0 / torch.clamp(dn, min=1e-12)
  n_out = torch.stack([-delta[i] * inv for i in range(3)])
  # a centre inside the box within rounding of its mid-plane across the
  # chosen face axis has no side to be pushed out of (COINCIDE): no normal
  eps = torch.finfo(dn.dtype).eps
  tol2 = (COINCIDE * eps) ** 2 * (1.0 + _dot3(center, center))
  push = torch.stack([torch.where(is_k[i] & (local[i] * local[i] > tol2),
                                  -sgn[i], torch.zeros_like(dn))
                      for i in range(3)])
  n = torch.where(inside[None], _mat_vec(bm, push), n_out)
  dist = torch.where(inside, -dn - radius, dn - radius)
  return dist, world - 0.5 * dist * n, n


def _boxbox_sat(p1, m1, p2, m2, s1, s2):
  """The face-SAT of a box pair at (p1, m1) and (p2, m2) with half-sizes s1
  and s2 (collision._box_box): over the 6 face axes of both boxes, the one
  of largest separation, first-max as jnp.argmax ties, signed from box 1 to
  box 2 (jnp.sign: a zero projection gives a zero normal). Returns (n, the
  support radii of box 1 and box 2 along n, the frame from n)."""
  s1, s2 = [float(x) for x in s1], [float(x) for x in s2]

  def radius(ax, m, s):
    return sum(torch.abs(_dot3(ax, m[:, i])) * s[i] for i in range(3))

  t = p2 - p1
  axes = [m[:, a] for m in (m1, m2) for a in range(3)]
  r_sum = [radius(ax, m1, s1) + radius(ax, m2, s2) for ax in axes]
  proj = [_dot3(ax, t) for ax in axes]
  best_sep = torch.abs(proj[0]) - r_sum[0]
  best_ax, best_proj = axes[0], proj[0]
  for a in range(1, 6):
    sep = torch.abs(proj[a]) - r_sum[a]
    take = sep > best_sep
    best_sep = torch.maximum(best_sep, sep)
    best_ax = torch.where(take[None], axes[a], best_ax)
    best_proj = torch.where(take, proj[a], best_proj)
  n = best_ax * torch.sign(best_proj)
  return n, radius(n, m1, s1), radius(n, m2, s2), _frame_from_normal(n)


def _boxbox_corner(cp, p1, m1, p2, m2, sat):
  """(dist, contact position) of one box's corner against the other box's
  slab along the shared SAT normal, with the lateral-overhang guard
  (collision._box_box corner_points); `sat` is _boxbox_sat's result."""
  n, sup1, sup2, _ = sat
  if cp.owner == 2:  # a corner of box 2 against box 1's slab
    pc, mc, sc, po, mo, so, sup_o, sgn = (p2, m2, cp.size2, p1, m1, cp.size1,
                                          sup1, 1.0)
  else:  # a corner of box 1 against box 2's slab
    pc, mc, sc, po, mo, so, sup_o, sgn = (p1, m1, cp.size1, p2, m2, cp.size2,
                                          sup2, -1.0)
  c = pc + _mat_vec(mc, _c(sc * cp.corner))
  rel = c - po
  dist = sgn * _dot3(rel, n) - sup_o
  local, n_loc = _mat_tvec(mo, rel), _mat_tvec(mo, n)
  big, slack = boxbox_guard(cp)  # rounded only in a float32 step
  so = _c(so)
  over = [torch.abs(local[i]) - so[i] - big * torch.abs(n_loc[i])
          for i in range(3)]
  overhang = torch.maximum(torch.maximum(over[0], over[1]), over[2]) - slack
  dist = torch.maximum(dist, overhang)
  return dist, torch.stack([c[i] - 0.5 * dist * sgn * n[i] for i in range(3)])


def boxbox_guard(cp):
  """The overhang guard's (big, slack) of a boxbox_corner point, whole:
  4 (max size1 + max size2) and 0.05 min(the other box's sizes)."""
  so = cp.size1 if cp.owner == 2 else cp.size2
  return (4.0 * (float(np.max(cp.size1)) + float(np.max(cp.size2))),
          0.05 * float(np.min(so)))


def _contact_geometry(tm, cp, geom_frame, const, sat_memo):
  """(dist (B,), frame (3 rows, 3, B), cpos (3, B)) of one contact point,
  the margin taken off dist (tilestep.py narrowphase); `sat_memo` holds
  each box pair's SAT within the step."""
  if cp.kind in ("plane_sphere", "plane_capend", "plane_boxcorner"):
    gpos, gquat = geom_frame(cp.g2)
    n_c = _c(cp.frame[0])
    pp = _c(cp.ppos)
    if cp.kind == "plane_boxcorner":
      end = gpos + _mat_vec(_quat_to_mat(gquat), _c(cp.size2 * cp.corner))
      r = 0.0
    elif cp.kind == "plane_capend":
      end = gpos + cp.sign * cp.half2 * _quat_to_mat(gquat)[:, 2]
      r = cp.r2
    else:
      end, r = gpos, cp.r2
    dist = (n_c[0] * (end[0] - pp[0]) + n_c[1] * (end[1] - pp[1]) +
            n_c[2] * (end[2] - pp[2])) - r
    scale = r + 0.5 * dist
    cpos = torch.stack([end[k] - n_c[k] * scale for k in range(3)])
    frame = const(cp.frame)[:, :, None].expand(3, 3, dist.shape[0])
    return dist - cp.margin, frame, cpos
  p1, q1 = geom_frame(cp.g1)
  p2, q2 = geom_frame(cp.g2)
  if cp.kind == "boxbox_corner":
    m1, m2 = _quat_to_mat(q1), _quat_to_mat(q2)
    key = (cp.g1, cp.g2)
    if key not in sat_memo:
      sat_memo[key] = _boxbox_sat(p1, m1, p2, m2, cp.size1, cp.size2)
    dist, cpos = _boxbox_corner(cp, p1, m1, p2, m2, sat_memo[key])
    return dist - cp.margin, sat_memo[key][3], cpos
  if cp.kind in ("sphere_box", "cap_box"):
    if cp.kind == "cap_box":  # the sphere at one capsule end
      p1 = p1 + cp.sign * cp.half1 * _quat_to_mat(q1)[:, 2]
    dist, cpos, n = _sphere_box_point(p1, cp.r1, p2, _quat_to_mat(q2),
                                      cp.size2)
    return dist - cp.margin, _frame_from_normal(n), cpos
  if cp.kind == "sphere_sphere":
    c1, c2 = p1, p2
  elif cp.kind == "sphere_cap":  # g2's segment point nearest the sphere
    u2 = _quat_to_mat(q2)[:, 2]
    t = torch.clamp(_dot3(p1 - p2, u2), -cp.half2, cp.half2)
    c1, c2 = p1, p2 + t * u2
  else:  # cap_cap (collision._capsule_capsule, smooth clamped)
    u1, u2 = _quat_to_mat(q1)[:, 2], _quat_to_mat(q2)[:, 2]
    rvec = p2 - p1
    uu = _dot3(u1, u2)
    ru1, ru2 = _dot3(rvec, u1), _dot3(rvec, u2)
    det = torch.clamp(1.0 - uu * uu, min=1e-9)
    t1c = torch.clamp((ru1 - uu * ru2) / det, -cp.half1, cp.half1)
    t2c = torch.clamp(_dot3(p1 + t1c * u1 - p2, u2), -cp.half2, cp.half2)
    t1c = torch.clamp(_dot3(p2 + t2c * u2 - p1, u1), -cp.half1, cp.half1)
    c1 = p1 + t1c * u1
    c2 = p2 + t2c * u2
  delta = c2 - c1
  dd = _dot3(delta, delta)
  # closest points that coincide to within rounding (crossing segments, a
  # centre on the other's axis) have no normal in exact arithmetic, and
  # the residue's direction is rounding: it is dropped, so the point's rows
  # are degenerate in float32 as they are in float64 (COINCIDE)
  eps = torch.finfo(delta.dtype).eps
  same = dd <= (COINCIDE * eps) ** 2 * (1.0 + _dot3(c1, c1))
  delta = torch.where(same, torch.zeros_like(delta), delta)
  dn = torch.sqrt(torch.clamp(torch.where(same, 0.0, dd), min=1e-24))
  n = delta / dn
  dist = dn - (cp.r1 + cp.r2)
  cpos = c1 + n * (cp.r1 + 0.5 * dist)
  return dist - cp.margin, _frame_from_normal(n), cpos


def _equality_rows(tm, er, qpos, xpos, xquat, cdof, zero):
  """The rows of one equality constraint as (Jacobian row, position
  error) pairs, a row being nv entries of (B,) tensors or None:
  JOINT q1 - qpos0_1 = poly(q2 - qpos0_2) (the polynomial's derivative in
  the second joint's column); CONNECT the two anchor points coincide;
  WELD the same with the anchors swapped, then 3 orientation rows scaled by
  the torquescale, their error the sin-weighted 2 sign(w) vec(q2^-1 q1)
  (JAX's _quat_sub_tb, not the log map)."""
  nv = tm.nv
  d = _c(er.data)
  if er.kind == EqType.JOINT:
    qa1, va1 = tm.jnt_qposadr[er.ob1], tm.jnt_dofadr[er.ob1]
    jrow = [None] * nv
    jrow[va1] = zero + 1.0
    q1 = qpos[qa1] - float(tm.qpos0[qa1])
    if er.ob2 < 0:
      return [(jrow, q1 - d[0])]
    qa2, va2 = tm.jnt_qposadr[er.ob2], tm.jnt_dofadr[er.ob2]
    dq = qpos[qa2] - float(tm.qpos0[qa2])
    dq2 = dq * dq
    dq3 = dq2 * dq
    poly = d[0] + d[1] * dq + d[2] * dq2 + d[3] * dq3 + d[4] * (dq2 * dq2)
    dpoly = d[1] + (2 * d[2]) * dq + (3 * d[3]) * dq2 + (4 * d[4]) * dq3
    jrow[va2] = -dpoly if jrow[va2] is None else jrow[va2] - dpoly
    return [(jrow, q1 - poly)]
  b1, b2 = er.ob1, er.ob2
  a1, a2 = (d[0:3], d[3:6]) if er.kind == EqType.CONNECT else (d[3:6],
                                                               d[0:3])
  p1 = xpos[b1] + _quat_rot(xquat[b1], a1)
  p2 = xpos[b2] + _quat_rot(xquat[b2], a2)
  m1, m2 = tm.dof_body_mask[:, b1], tm.dof_body_mask[:, b2]
  # point-translation Jacobians of the two anchors
  jc1 = {k: cdof[k][1] + _cross(cdof[k][0], p1) for k in range(nv) if m1[k]}
  jc2 = {k: cdof[k][1] + _cross(cdof[k][0], p2) for k in range(nv) if m2[k]}
  rows = []
  for i in range(3):
    jrow = [None] * nv
    for k in range(nv):
      if m1[k]:
        jrow[k] = jc1[k][i]
      if m2[k]:
        jrow[k] = -jc2[k][i] if jrow[k] is None else jrow[k] - jc2[k][i]
    rows.append((jrow, p1[i] - p2[i]))
  if er.kind == EqType.WELD:
    tq = max(d[10], 1e-8)
    q1r = _quat_mul(xquat[b1], d[6:10])
    q2 = xquat[b2]
    dq = _quat_mul(torch.stack([q2[0], -q2[1], -q2[2], -q2[3]]), q1r)
    s = torch.where(dq[0] < 0, -2.0, 2.0).to(dq.dtype)  # shortest path
    for i in range(3):
      jrow = [None] * nv
      for k in range(nv):
        sgn = float(m1[k]) - float(m2[k])
        if sgn != 0.0:
          jrow[k] = (tq * sgn) * cdof[k][0][i]
      rows.append((jrow, tq * (dq[1 + i] * s)))
  return rows


def _constraint_solve(tm, qpos, qvel, xpos, xquat, cdof, L, qacc_smooth,
                      efc_lambda, const):
  """Rows, Delassus operator, preconditioned APGD; (qfrc (nv, B),
  converged physical duals (nrow, B), the ContactView)."""
  nv, nrow = tm.nv, tm.nrow
  B = qpos.shape[1]
  dtype, dev = qpos.dtype, qpos.device
  cdof_ang = torch.stack([c[0] for c in cdof])  # (nv, 3, B)
  cdof_lin = torch.stack([c[1] for c in cdof])

  J_parts, pos_parts, act_parts, imp_parts, k_parts, b_parts = \
      [], [], [], [], [], []
  gf_memo = {}

  def geom_frame(g):
    if g not in gf_memo:
      bg = tm.geom_bodyid[g]
      gf_memo[g] = (xpos[bg] + _quat_rot(xquat[bg], _c(tm.geom_pos[g])),
                    _quat_mul(xquat[bg], _c(tm.geom_quat[g])))
    return gf_memo[g]

  def rows_of(cps, nr, ang=False, axis=0):
    """Append the rows of contact points cps: nr translational rows each
    (the frame's first nr directions), or with ang one angular row each
    about frame direction `axis` (the relative angular velocity: torsional
    about the normal, rolling about a tangent; no positional error, the
    point's impedance, solref and activity)."""
    npt = len(cps)
    dist = torch.stack([geo[id(cp)][0] for cp in cps])  # (npt, B)
    frame = torch.stack([geo[id(cp)][1][axis:axis + nr]
                         for cp in cps])  # (npt, nr, 3, B)
    # relative-velocity Jacobian: sign per dof from the two bodies' paths
    sgn = const([[float(tm.dof_body_mask[k, cp.body2])
                  - float(tm.dof_body_mask[k, cp.body1])
                  for k in range(nv)] for cp in cps])  # (npt, nv)
    if ang:
      jp = cdof_ang[None].expand(npt, nv, 3, B)
    else:
      cpos = torch.stack([geo[id(cp)][2] for cp in cps])  # (npt, 3, B)
      jp = cdof_lin[None] + torch.linalg.cross(
          cdof_ang[None], cpos[:, None], dim=2)  # (npt, nv, 3, B)
    J_c = torch.sum(frame[:, :, None] * jp[:, None], dim=3)
    J_c = J_c * sgn[:, None, :, None]  # (npt, nr, nv, B)
    J_parts.append(J_c.reshape(nr * npt, nv, B))
    zc = torch.zeros_like(dist)
    pos_parts.append(torch.stack(
        [zc if ang else torch.clamp(dist, max=0.0)] + [zc] * (nr - 1),
        dim=1).reshape(nr * npt, B))
    act_parts.append((dist < 0)[:, None].expand(npt, nr, B)
                     .reshape(nr * npt, B))
    params = [pair_params(cp, dtype) for cp in cps]
    ic = const([impedance_consts(si) for _, si in params])  # (npt, 5)
    imp = _impedance(dist, *(ic[:, i:i + 1] for i in range(5)))
    imp_parts.append(imp[:, None].expand(npt, nr, B).reshape(nr * npt, B))
    kbs = [kb(sr, float(si[1])) for sr, si in params]
    k_parts.append(const([[v[0]] * nr for v in kbs]).reshape(nr * npt))
    b_parts.append(const([[v[1]] * nr for v in kbs]).reshape(nr * npt))

  # contact rows: condim>=3 points (n, t1, t2), condim-1 points (n), the
  # torsional rows of the condim>=4 points, then the rolling rows of the
  # condim-6 points, about the first tangent for all of them, then about
  # the second
  fric, ones, tor, roll = row_points(tm)
  sat_memo = {}
  geo = {id(cp): _contact_geometry(tm, cp, geom_frame, const, sat_memo)
         for cp in fric + ones}
  for cps, nr in ((fric, 3), (ones, 1)):
    if cps:
      rows_of(cps, nr)
  if tor:
    rows_of(tor, 1, ang=True)
  for axis in (1, 2):
    if roll:
      rows_of(roll, 1, ang=True, axis=axis)
  pairs = tuple((cp.g1, cp.g2) for cp in tm.con_points)
  if tm.ncon:
    contact = ContactView(
        dist=torch.stack([geo[id(cp)][0] for cp in tm.con_points]),
        frame=torch.stack([geo[id(cp)][1] for cp in tm.con_points]),
        pairs=pairs)
  else:
    contact = ContactView(dist=torch.zeros((0, B), dtype=dtype, device=dev),
                          frame=torch.zeros((0, 3, 3, B), dtype=dtype,
                                            device=dev), pairs=pairs)

  # limit rows: joints, then fixed tendons (constant Jacobians)
  lims = [(qpos[tm.lim_qadr[li]], {tm.lim_vadr[li]: 1.0}, tm.lim_lo[li],
           tm.lim_hi[li], tm.lim_margin[li], tm.lim_solref[li])
          for li in range(len(tm.lim_jnt))]
  for li, t in enumerate(tm.ten_lim):
    ln, coefs = None, {}
    for qadr, vadr, coef in tm.ten_wraps[t]:
      term = coef * qpos[qadr]
      ln = term if ln is None else ln + term
      coefs[vadr] = coefs.get(vadr, 0.0) + coef
    lims.append((ln, coefs, float(tm.ten_lim_range[li, 0]),
                 float(tm.ten_lim_range[li, 1]), tm.ten_lim_margin[li],
                 tm.ten_lim_solref[li]))
  nl = len(lims)
  if nl:
    q = torch.stack([x[0] for x in lims])  # (nl, B)
    lo = (q - const([x[2] for x in lims])[:, None]) \
        - const([x[4] for x in lims])[:, None]
    hi = (const([x[3] for x in lims])[:, None] - q) \
        - const([x[4] for x in lims])[:, None]
    posv = torch.stack([lo, hi], dim=1).reshape(2 * nl, B)
    jl = np.zeros((2 * nl, nv))
    for li, x in enumerate(lims):
      for vadr, coef in x[1].items():
        jl[2 * li, vadr] = coef
        jl[2 * li + 1, vadr] = -coef
    J_parts.append(const(jl)[:, :, None].expand(2 * nl, nv, B))
    pos_parts.append(torch.clamp(posv, max=0.0))
    act_parts.append(posv < 0)
    ic = impedance_consts(_DEFAULT_SOLIMP)
    imp_parts.append(_impedance(posv, *const(ic)))
    kbs = [kb(x[5], ic[1]) for x in lims]
    k_parts.append(const([[v[0]] * 2 for v in kbs]).reshape(2 * nl))
    b_parts.append(const([[v[1]] * 2 for v in kbs]).reshape(2 * nl))

  # equality rows: bilateral (a signed position error, always active,
  # never projected)
  zero = torch.zeros_like(qpos[0])
  for er in tm.eq_rows:
    rows = _equality_rows(tm, er, qpos, xpos, xquat, cdof, zero)
    J_parts.append(torch.stack([
        torch.stack([v if v is not None else zero for v in jrow])
        for jrow, _ in rows]))
    posv = torch.stack([p for _, p in rows])
    pos_parts.append(posv)
    act_parts.append(torch.ones_like(posv, dtype=torch.bool))
    imp_parts.append(_impedance(posv, *const(impedance_consts(er.solimp))))
    k_eq, b_eq = kb(er.solref, float(er.solimp[1]))
    k_parts.append(const([k_eq] * len(rows)))
    b_parts.append(const([b_eq] * len(rows)))

  J = torch.cat(J_parts)  # (nrow, nv, B)
  rows_pos = torch.cat(pos_parts)
  active_rows = torch.cat(act_parts)
  imp_s = torch.cat(imp_parts)
  rows_k = torch.cat(k_parts)[:, None]
  rows_b = torch.cat(b_parts)[:, None]

  def jmat_vec(v):  # J v: (nv, B) -> (nrow, B)
    return torch.sum(J * v[None], dim=1)

  def jmat_t_vec(v):  # J^T v: (nrow, B) -> (nv, B)
    return torch.sum(J * v[:, None], dim=0)

  # aref = -imp (k pos + b J qvel)
  vel_r = jmat_vec(qvel)
  aref = -imp_s * (rows_k * rows_pos + rows_b * vel_r)

  dense = amat_is_dense(nrow)
  Jt = J.permute(1, 0, 2)  # (nv, nrow, B)
  X = _chol_solve(L, Jt)  # M^-1 J^T
  if dense:
    amat = torch.sum(J[:, :, None] * X[None], dim=1)  # (nrow, nrow, B)
    raw_diag = torch.diagonal(amat).T
  else:
    raw_diag = torch.sum(Jt * X, dim=0)
  diag = torch.clamp(raw_diag, min=1e-10)
  a0 = jmat_vec(qacc_smooth)

  # softness R = (1 - d)/d * A_rr, where the equality rows take the model's
  # constant diagApprox for A_rr; degenerate rows (A_rr ~ 0 relative to the
  # candidate's largest, over all rows) are deactivated, except the
  # equality rows, whose R keeps the dual bounded
  neq = tm.neq_rows
  nuni = nrow - neq  # the unilateral rows come first
  reg_base = diag
  if neq:
    eq_da = np.concatenate([er.diagapprox for er in tm.eq_rows])
    reg_base = torch.cat([diag[:nuni], const(eq_da)[:, None].expand(neq, B)])
  reg = (1.0 - imp_s) / imp_s * reg_base
  nondeg = raw_diag > 1e-8 * torch.max(raw_diag, dim=0, keepdim=True)[0]
  if neq:
    nondeg = torch.cat([nondeg[:nuni], torch.ones_like(nondeg[nuni:])])
  active = active_rows & nondeg

  # Jacobi preconditioning, tangent scales tied inside a point and the two
  # rolling rows' scales tied, so the cone and the rolling disc stay
  # circular
  nf, ntor, nroll = len(fric), len(tor), len(roll)
  off_ang = 3 * nf + len(ones)  # first torsional row
  roll0 = off_ang + ntor  # first rolling row
  lim0 = roll0 + 2 * nroll  # first limit row
  tor_f = [i for i, cp in enumerate(fric) if cp.condim >= 4]  # tor's points
  roll_f = [i for i, cp in enumerate(fric) if cp.condim >= 6]
  dr = diag + reg
  if nf:
    fc = dr[:3 * nf].reshape(nf, 3, B)
    mt = 0.5 * (fc[:, 1] + fc[:, 2])
    dr_s = torch.cat([torch.stack([fc[:, 0], mt, mt], dim=1)
                      .reshape(3 * nf, B), dr[3 * nf:]])
  else:
    dr_s = dr
  if nroll:
    mr = 0.5 * (dr_s[roll0:roll0 + nroll] + dr_s[roll0 + nroll:lim0])
    dr_s = torch.cat([dr_s[:roll0], mr, mr, dr_s[lim0:]])
  s_pre = 1.0 / torch.sqrt(torch.clamp(dr_s, min=1e-12))
  if nf:
    fs = s_pre[:3 * nf].reshape(nf, 3, B)
    mu = const([cp.mu for cp in fric])[:, None]
    mu_t = mu * fs[:, 0] / fs[:, 1]
  if ntor:  # torsional caps relative to the point's normal scale
    mu_tor = (const([cp.mu_tor for cp in tor])[:, None] * fs[tor_f, 0]
              / s_pre[off_ang:roll0])
  if nroll:  # rolling caps likewise, one per pair of rows
    mu_roll = (const([cp.mu_roll for cp in roll])[:, None] * fs[roll_f, 0]
               / s_pre[roll0:roll0 + nroll])

  def project(g):
    parts = []
    if nf:
      gc = g[:3 * nf].reshape(nf, 3, B)
      gn = torch.clamp(gc[:, 0], min=0.0)
      gt1, gt2 = gc[:, 1], gc[:, 2]
      tsq = gt1 * gt1 + gt2 * gt2
      tiny = tsq < 1e-24
      tnorm = torch.sqrt(torch.where(tiny, torch.ones_like(tsq), tsq))
      tnorm = torch.where(tiny, torch.zeros_like(tnorm), tnorm)
      cap = mu_t * gn
      scale = torch.where(tnorm > cap, cap / torch.clamp(tnorm, min=1e-12),
                          torch.ones_like(tnorm))
      parts.append(torch.stack([gn, gt1 * scale, gt2 * scale], dim=1)
                   .reshape(3 * nf, B))
    if off_ang > 3 * nf:  # condim-1 normals
      parts.append(torch.clamp(g[3 * nf:off_ang], min=0.0))
    if ntor:
      # an interval capped by the same point's projected normal iterate
      # (not a coupled elliptic cone: the JAX package's approximation)
      cap = mu_tor * gn[tor_f]
      parts.append(torch.clamp(g[off_ang:roll0], min=-cap, max=cap))
    if nroll:  # a disc capped by the point's projected normal iterate
      r1, r2 = g[roll0:roll0 + nroll], g[roll0 + nroll:lim0]
      rsq = r1 * r1 + r2 * r2
      tiny = rsq < 1e-24
      rnorm = torch.sqrt(torch.where(tiny, torch.ones_like(rsq), rsq))
      rnorm = torch.where(tiny, torch.zeros_like(rnorm), rnorm)
      cap = mu_roll * gn[roll_f]
      scale = torch.where(rnorm > cap, cap / torch.clamp(rnorm, min=1e-12),
                          torch.ones_like(rnorm))
      parts += [r1 * scale, r2 * scale]
    if nuni > lim0:  # joint and tendon limits
      parts.append(torch.clamp(g[lim0:nuni], min=0.0))
    if neq:  # bilateral equality rows: no projection
      parts.append(g[nuni:])
    g = torch.cat(parts) if len(parts) > 1 else parts[0]
    return torch.where(active, g, torch.zeros_like(g))

  dinv = 1.0 / (diag + reg)
  g_init = project((aref - a0) * dinv / s_pre)
  if efc_lambda is not None:
    # warm start from the previous step's physical duals, unless all-zero;
    # the angular (torsional, rolling) and equality rows always start
    # cold: their duals can be non-unique, and warm-starting them
    # integrates drift
    cold = torch.sum(torch.abs(efc_lambda), dim=0) == 0
    warm = efc_lambda / s_pre
    if lim0 > off_ang or neq:
      warm = torch.cat([warm[:off_ang], g_init[off_ang:lim0],
                        warm[lim0:nuni], g_init[nuni:]])
    g0 = project(torch.where(cold[None], g_init, warm))
  else:
    g0 = g_init
  b_vec = a0 - aref

  if dense:
    def amul(v):
      return torch.sum(amat * v[None], dim=1)
  else:
    def amul(v):  # J M^-1 J^T v, the Delassus matrix never formed
      return jmat_vec(_chol_solve(L, jmat_t_vec(v)))

  # step denominators floored at 1 (an all-inactive candidate stays finite)
  if dense:
    row_sum = (s_pre * torch.sum(torch.abs(amat) * s_pre[None], dim=1)
               + s_pre * s_pre * reg)
    step = 1.0 / torch.clamp(torch.max(
        torch.where(active, row_sum, torch.zeros_like(row_sum)), dim=0)[0],
        min=1.0)
  else:
    def opmul(v):
      v = torch.where(active, v, torch.zeros_like(v))
      sv = s_pre * v
      out = s_pre * (amul(sv) + reg * sv)
      return torch.where(active, out, torch.zeros_like(out))

    v_p = active.to(dtype)
    for _ in range(_POWER_ITERS):
      w_p = opmul(v_p)
      v_p = w_p / torch.sqrt(torch.clamp(torch.sum(w_p * w_p, dim=0),
                                         min=1e-30))
    lam = torch.sum(v_p * opmul(v_p), dim=0)
    step = 1.0 / torch.clamp(1.25 * lam, min=1.0)

  def grad(g):
    f = s_pre * g
    return s_pre * (amul(f) + reg * f + b_vec)

  g, y = g0, g0
  t = torch.ones((B,), dtype=dtype, device=dev)
  for _ in range(_ITERATIONS):
    g_new = project(y - step[None] * grad(y))
    t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
    beta = (t - 1.0) / t_new
    dg = g_new - g
    reverse = torch.sum(dg * (y - g_new), dim=0) > 0
    y = torch.where(reverse[None], g_new, g_new + beta * dg)
    t = torch.where(reverse, torch.ones_like(t), t_new)
    g = g_new
  f = s_pre * g  # physical dual forces
  return jmat_t_vec(f), f, contact
