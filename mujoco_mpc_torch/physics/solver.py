"""Soft-constraint solver: contacts, joint and tendon limits, equalities.

Counterpart of mujoco_mpc_tpu/physics/solver.py: MuJoCo-style compliant
constraints (impedance from solimp, reference acceleration from solref)
solved by a fixed number of accelerated projected-gradient (APGD)
iterations on the regularized dual over the Delassus operator, Jacobi
preconditioned, warm-started from the previous step's duals
(Data.efc_lambda), with an elliptic friction cone. The Delassus matrix is
materialized for a small row count and applied matrix-free otherwise
(tilestep.amat_is_dense), the step size from Gershgorin row sums or power
iteration accordingly. Every index set is static: a solve launches the
same ops for any state, and reads nothing back to the host.

Row layout (as JAX's, not the tile step's): contact rows (one per condim-1
point, three per condim >= 3 point, in point order), torsional rows (one
per condim >= 4 point), rolling rows (per condim-6 point about the first
tangent, then about the second), joint limits (lo, hi per scalar joint,
then one per ball joint), tendon limits (lo, hi), equality rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mujoco_mpc_torch.ops import linalg
from mujoco_mpc_torch.physics import collision, dynamics
from mujoco_mpc_torch.physics import math as pmath
from mujoco_mpc_torch.physics.tilestep import amat_is_dense
from mujoco_mpc_torch.physics.types import Data, EqType, JointType, Model

_MINIMP, _MAXIMP = 1e-4, 0.9999
_DEFAULT_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)
_ITERATIONS = 12  # APGD iterations, as the JAX package and the tile step
_POWER_ITERS = 8  # power iterations for the matrix-free step size


def _impedance(pos, solimp):
  """MuJoCo's impedance sigmoid d(pos) in (0, 1)."""
  d0, d1, width, mid, power = (solimp[..., i] for i in range(5))
  x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-12), 0.0, 1.0)
  mid = torch.clamp(mid, 1e-4, 1 - 1e-4)
  power = torch.clamp(power, min=1.0)
  y_lo = torch.pow(x / mid, power) * mid
  y_hi = 1.0 - torch.pow((1 - x) / (1 - mid), power) * (1 - mid)
  y = torch.where(x < mid, y_lo, y_hi)
  return torch.clamp(d0 + y * (d1 - d0), _MINIMP, _MAXIMP)


def _kb(solref, dmax) -> Tuple[torch.Tensor, torch.Tensor]:
  """Stiffness and damping from solref, the direct (negative) form too."""
  timeconst = torch.clamp(solref[..., 0], min=1e-8)
  dampratio = torch.clamp(solref[..., 1], min=1e-8)
  k_std = 1.0 / (dmax * dmax * timeconst * timeconst *
                 dampratio * dampratio)
  b_std = 2.0 / (dmax * timeconst)
  k_dir = -solref[..., 0] / (dmax * dmax)
  b_dir = -solref[..., 1] / dmax
  direct = (solref[..., 0] <= 0) & (solref[..., 1] <= 0)
  return torch.where(direct, k_dir, k_std), torch.where(direct, b_dir, b_std)


def _c(m: Model, key, build):
  return m.const(("solver", key), build)


def _idx(m: Model, key, values) -> torch.Tensor:
  return _c(m, key, lambda: torch.as_tensor(
      np.asarray(values, np.int64), device=m.device))


def _repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
  """x (..., n, c) with each row repeated k times in place (..., k n, c)."""
  return x[..., :, None, :].expand(*x.shape[:-1], k, x.shape[-1]).reshape(
      *x.shape[:-2], k * x.shape[-2], x.shape[-1])


def _body_masks(m: Model, bodies):
  """(k, nv) bool: the dofs on each body's path."""
  return m.dof_body_mask.T[bodies]


def _contact_jacobian(m: Model, d: Data) -> torch.Tensor:
  """(..., npt, 3, nv): contact-frame relative velocity Jacobian."""
  con = d.contact
  b1 = [m.geom_bodyid[g1] for g1, _ in con.pairs]
  b2 = [m.geom_bodyid[g2] for _, g2 in con.pairs]
  mask1 = _c(m, "cmask1", lambda: _body_masks(m, _idx(m, "cb1", b1)))
  mask2 = _c(m, "cmask2", lambda: _body_masks(m, _idx(m, "cb2", b2)))
  cdof = d.cdof[..., None, :, :]  # (..., 1, nv, 6)
  jac_all = cdof[..., 3:] + pmath.cross(cdof[..., :3],
                                        con.pos[..., :, None, :])
  zero = torch.zeros((), dtype=jac_all.dtype, device=jac_all.device)
  jrel = (torch.where(mask2[..., None], jac_all, zero) -
          torch.where(mask1[..., None], jac_all, zero))  # (..., npt, nv, 3)
  return torch.einsum("...prc,...pnc->...prn", con.frame, jrel)


def _angular_rows(m: Model, d: Data, pts, axes, key):
  """(..., len(pts) * len(axes), nv) relative angular-velocity rows about
  contact-frame axes (0: normal, torsion; 1, 2: tangents, rolling), axis
  major."""
  con = d.contact
  idx = _idx(m, key + "_idx", pts)
  b1 = [m.geom_bodyid[con.pairs[i][0]] for i in pts]
  b2 = [m.geom_bodyid[con.pairs[i][1]] for i in pts]
  mask1 = _c(m, key + "_m1", lambda: _body_masks(m, _idx(m, key + "_b1",
                                                          b1)))
  mask2 = _c(m, key + "_m2", lambda: _body_masks(m, _idx(m, key + "_b2",
                                                          b2)))
  jang = d.cdof[..., None, :, :3]  # (..., 1, nv, 3)
  zero = torch.zeros((), dtype=jang.dtype, device=jang.device)
  jrel = (torch.where(mask2[..., None], jang, zero) -
          torch.where(mask1[..., None], jang, zero))  # (..., k, nv, 3)
  frame = con.frame[..., idx, :, :]
  rows = [torch.sum(jrel * frame[..., a, :][..., None, :], dim=-1)
          for a in axes]
  return torch.cat(rows, dim=-2) if len(rows) > 1 else rows[0]


def _limit_rows(m: Model, d: Data):
  """Limit rows: two-sided for scalar joints, the rotation angle for ball
  joints (range[1] bounds it)."""
  lim = [j for j in range(m.njnt) if m.jnt_limited[j] and
         m.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)]
  ball = [j for j in range(m.njnt)
          if m.jnt_limited[j] and m.jnt_type[j] == JointType.BALL]
  if not lim and not ball:
    return None
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  jmats, poss, solrefs = [], [], []
  rng, margin_all = m.jnt_range.to(dtype), m.jnt_margin.to(dtype)
  solref_all = m.jnt_solref.to(dtype)
  if lim:
    def jmat_np():
      out = np.zeros((2 * len(lim), m.nv))
      for i, j in enumerate(lim):
        out[2 * i, m.jnt_dofadr[j]] = 1.0
        out[2 * i + 1, m.jnt_dofadr[j]] = -1.0
      return torch.as_tensor(out, dtype=dtype, device=m.device)

    qadr = _idx(m, "lim_qadr", [m.jnt_qposadr[j] for j in lim])
    jidx = _idx(m, "lim_j", lim)
    q = d.qpos[..., qadr]
    lo, hi, margin = rng[jidx, 0], rng[jidx, 1], margin_all[jidx]
    jmats.append(m.const(("lim_jmat", dtype), jmat_np).expand(
        batch + (2 * len(lim), m.nv)))
    poss.append(torch.stack([q - lo - margin, hi - q - margin],
                            dim=-1).reshape(batch + (2 * len(lim),)))
    solrefs.append(_repeat_rows(solref_all[jidx], 2))
  for j in ball:
    qadr, vadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
    quat = d.qpos[..., qadr:qadr + 4]
    ident = torch.cat([torch.ones_like(quat[..., :1]),
                       torch.zeros_like(quat[..., 1:])], dim=-1)
    ang, axis = pmath.safe_norm(pmath.quat_sub(quat, ident))
    row = torch.cat([axis.new_zeros(batch + (vadr,)), -axis,
                     axis.new_zeros(batch + (m.nv - vadr - 3,))], dim=-1)
    jmats.append(row[..., None, :])
    poss.append(rng[j, 1] - ang - margin_all[j])
    solrefs.append(solref_all[j][None])
  return (torch.cat(jmats, dim=-2), torch.cat(poss, dim=-1),
          torch.cat(solrefs))


def _tendon_limit_rows(m: Model, d: Data):
  """Two-sided limit rows of the limited fixed tendons."""
  lim = [t for t in range(m.ntendon) if m.tendon_limited[t]]
  if not lim:
    return None
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  jten = m.const(("tendon_jac", dtype), lambda: torch.as_tensor(
      dynamics.tendon_jacobian_np(m), dtype=dtype, device=m.device))
  ln, _ = dynamics.tendon_lengths(m, d)
  rng, mg = m.tendon_range.to(dtype), m.tendon_margin.to(dtype)
  sref = m.tendon_solref_lim.to(dtype)
  jmats, poss, solrefs = [], [], []
  for t in lim:
    row = jten[t]
    jmats.append(torch.stack([row, -row]).expand(batch + (2, m.nv)))
    poss.append(torch.stack([ln[..., t] - rng[t, 0] - mg[t],
                             rng[t, 1] - ln[..., t] - mg[t]], dim=-1))
    solrefs.append(sref[t].expand(2, 2))
  return (torch.cat(jmats, dim=-2), torch.cat(poss, dim=-1),
          torch.cat(solrefs))


def _unit(m: Model, i: int, dtype) -> torch.Tensor:
  """The unit vector e_i of length nv."""
  return _c(m, ("unit", i, dtype), lambda: torch.as_tensor(
      np.eye(m.nv)[i], dtype=dtype, device=m.device))


def _point_jacobian(m: Model, d: Data, body: int, point):
  """(..., 3, nv) translational Jacobian of a world point on `body`."""
  mask = m.dof_body_mask[:, body]
  jac = d.cdof[..., 3:] + pmath.cross(d.cdof[..., :3], point[..., None, :])
  return torch.where(mask[:, None], jac,
                     torch.zeros_like(jac)).transpose(-1, -2)


def _equality_rows(m: Model, d: Data):
  """Bilateral rows: connect (3), weld (6), joint coupling (1), each with
  its own solref and solimp."""
  dtype = d.qpos.dtype
  batch = d.qpos.shape[:-1]
  jmats, poss, solrefs, solimps = [], [], [], []
  eq_data = m.eq_data.to(dtype)
  sref, simp = m.eq_solref.to(dtype), m.eq_solimp.to(dtype)
  qpos0 = m.qpos0.to(dtype)
  for e in range(m.neq):
    if not m.eq_active0[e]:
      continue
    et, b1, b2 = m.eq_type[e], m.eq_obj1id[e], m.eq_obj2id[e]
    data = eq_data[e]
    if et == EqType.CONNECT:
      p1 = d.xpos[..., b1, :] + pmath.quat_rot(d.xquat[..., b1, :], data[0:3])
      p2 = d.xpos[..., b2, :] + pmath.quat_rot(d.xquat[..., b2, :], data[3:6])
      jmats.append(_point_jacobian(m, d, b1, p1) -
                   _point_jacobian(m, d, b2, p2))
      poss.append(p1 - p2)
      nrows = 3
    elif et == EqType.WELD:
      p1 = d.xpos[..., b1, :] + pmath.quat_rot(d.xquat[..., b1, :], data[3:6])
      p2 = d.xpos[..., b2, :] + pmath.quat_rot(d.xquat[..., b2, :], data[0:3])
      jtr = _point_jacobian(m, d, b1, p1) - _point_jacobian(m, d, b2, p2)
      zero = torch.zeros_like(d.cdof[..., :3])
      jrot = (torch.where(m.dof_body_mask[:, b1][:, None], d.cdof[..., :3],
                          zero) -
              torch.where(m.dof_body_mask[:, b2][:, None], d.cdof[..., :3],
                          zero)).transpose(-1, -2)
      q1r = pmath.quat_mul(d.xquat[..., b1, :], data[6:10])
      rot_err = pmath.quat_sub(q1r, d.xquat[..., b2, :])
      tq = torch.clamp(data[10], min=1e-8)
      jmats.append(torch.cat([jtr, tq * jrot], dim=-2))
      poss.append(torch.cat([p1 - p2, tq * rot_err], dim=-1))
      nrows = 6
    else:  # joint coupling: q1 - q1_0 = poly(q2 - q2_0)
      j1, j2 = b1, b2
      q1 = d.qpos[..., m.jnt_qposadr[j1]] - qpos0[m.jnt_qposadr[j1]]
      e1 = _unit(m, m.jnt_dofadr[j1], dtype)
      if j2 >= 0:
        dq = d.qpos[..., m.jnt_qposadr[j2]] - qpos0[m.jnt_qposadr[j2]]
        poly = (data[0] + data[1] * dq + data[2] * dq ** 2 +
                data[3] * dq ** 3 + data[4] * dq ** 4)
        dpoly = (data[1] + 2 * data[2] * dq + 3 * data[3] * dq ** 2 +
                 4 * data[4] * dq ** 3)
        e2 = _unit(m, m.jnt_dofadr[j2], dtype)
        row = e1 - dpoly[..., None] * e2
        pos = q1 - poly
      else:
        row = e1.expand(batch + (m.nv,))
        pos = q1 - data[0]
      jmats.append(row[..., None, :])
      poss.append(pos[..., None])
      nrows = 1
    solrefs.append(sref[e].expand(nrows, 2))
    solimps.append(simp[e].expand(nrows, 5))
  if not jmats:
    return None
  return (torch.cat(jmats, dim=-2), torch.cat(poss, dim=-1),
          torch.cat(solrefs), torch.cat(solimps))


def nrow_static(m: Model) -> int:
  """The model's constraint-row count (the warm start's size)."""
  ncon_rows = sum(1 if c == 1 else 3 for c in collision.point_condims(m))
  tor_pts, roll_pts = collision.angular_points(m)
  nlim = sum((2 if m.jnt_type[j] in (JointType.HINGE, JointType.SLIDE)
              else 1) for j in range(m.njnt) if m.jnt_limited[j])
  nlim += 2 * sum(1 for t in range(m.ntendon) if m.tendon_limited[t])
  neq_rows = sum({EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1}[
      m.eq_type[e]] for e in range(m.neq) if m.eq_active0[e])
  return ncon_rows + len(tor_pts) + 2 * len(roll_pts) + nlim + neq_rows


class _Layout:
  """The static index sets of a model's contact rows."""

  def __init__(self, m: Model):
    cd = collision.point_condims(m)
    ncon = len(cd)
    self.ncon = ncon
    widths = [1 if c == 1 else 3 for c in cd]
    self.sel = np.concatenate(
        [np.arange(3 * i, 3 * i + w) for i, w in enumerate(widths)]
    ).astype(np.int64) if ncon else np.zeros((0,), np.int64)
    self.ncrow = len(self.sel)
    nrm = np.cumsum([0] + widths)[:-1].astype(np.int64)
    fric = np.asarray([i for i in range(ncon) if cd[i] >= 3], np.int64)
    self.nrm = nrm
    self.fric = fric
    self.t1 = nrm[fric] + 1
    self.t2 = nrm[fric] + 2
    self.tor, self.roll = collision.angular_points(m)
    self.nang = len(self.tor) + 2 * len(self.roll)
    # the contact block from [normals, tangent1s, tangent2s]
    order = np.concatenate([nrm, self.t1, self.t2])
    self.inv = np.argsort(order).astype(np.int64)
    nr = np.zeros((self.ncrow,), bool)
    nr[nrm] = True
    self.norm_row = nr


def solve(m: Model, d: Data, qacc_smooth: torch.Tensor,
          chol_factor: torch.Tensor) -> Data:
  """qfrc_constraint, the contact forces and the next warm start, from
  the unconstrained acceleration qacc_smooth (nv,) and the Cholesky
  factor of the implicit-damping inertia."""
  dtype = d.qpos.dtype
  dev = d.qpos.device
  batch = d.qpos.shape[:-1]
  have_contacts = len(m.collision_pairs) > 0
  lay = m.const("solver_layout", lambda: _Layout(m)) if have_contacts \
      else None

  j_blocks, pos_list, solref_list, solimp_list = [], [], [], []
  ncrow = nang = 0
  if have_contacts:
    con = d.contact
    sel = _idx(m, "sel", lay.sel)
    ncrow, nang = lay.ncrow, lay.nang
    jc = _contact_jacobian(m, d)
    j_blocks.append(jc.reshape(batch + (-1, m.nv))[..., sel, :])
    # every row of a contact carries its distance (shared impedance); the
    # position term of aref is masked to the normal row below
    pos3 = con.dist[..., :, None].expand(batch + (lay.ncon, 3))
    pos_list.append(pos3.reshape(batch + (-1,))[..., sel])
    solref_list.append(_repeat_rows(con.solref, 3)[..., sel, :])
    solimp_list.append(_repeat_rows(con.solimp, 3)[..., sel, :])
    if lay.tor:
      ti = _idx(m, "tor", lay.tor)
      j_blocks.append(_angular_rows(m, d, lay.tor, [0], "tor"))
      pos_list.append(con.dist[..., ti])
      solref_list.append(con.solref[..., ti, :])
      solimp_list.append(con.solimp[..., ti, :])
    if lay.roll:
      ri = _idx(m, "roll", lay.roll)
      j_blocks.append(_angular_rows(m, d, lay.roll, [1, 2], "roll"))
      pos_list.append(con.dist[..., ri].repeat(
          (1,) * len(batch) + (2,)))
      solref_list.append(con.solref[..., ri, :].repeat(
          (1,) * len(batch) + (2, 1)))
      solimp_list.append(con.solimp[..., ri, :].repeat(
          (1,) * len(batch) + (2, 1)))

  def expand(x, width):
    return x.expand(batch + x.shape[-width:]) if x.dim() == width else x

  nlim = 0
  for block in (_limit_rows(m, d), _tendon_limit_rows(m, d)):
    if block is not None:
      jl, pl, sl = block
      nlim += jl.shape[-2]
      j_blocks.append(jl)
      pos_list.append(pl)
      solref_list.append(expand(sl, 2))
      solimp_list.append(m.const(("default_solimp", dtype), lambda:
                                 torch.tensor(_DEFAULT_SOLIMP, dtype=dtype,
                                              device=dev)).expand(
          batch + (jl.shape[-2], 5)))
  eq = _equality_rows(m, d) if m.neq else None
  neq_rows = 0
  if eq is not None:
    je, pe, sre, sie = eq
    neq_rows = je.shape[-2]
    j_blocks.append(je)
    pos_list.append(pe)
    solref_list.append(expand(sre, 2))
    solimp_list.append(expand(sie, 2))

  if not j_blocks:
    return d.replace(qfrc_constraint=torch.zeros_like(d.qvel))

  jmat = torch.cat(j_blocks, dim=-2)  # (..., nrow, nv)
  pos = torch.cat(pos_list, dim=-1)
  solref = torch.cat([expand(s, 2) for s in solref_list], dim=-2)
  solimp = torch.cat([expand(s, 2) for s in solimp_list], dim=-2)
  nrow = jmat.shape[-2]
  nuni = nrow - neq_rows

  # active rows: violated unilateral rows (a normal drives its friction
  # rows), every equality row
  if have_contacts:
    con = d.contact
    con_active = (con.dist < 0)[..., :, None].expand(
        batch + (lay.ncon, 3)).reshape(batch + (-1,))[..., sel]
    parts = [con_active]
    if lay.tor:
      parts.append(con.dist[..., ti] < 0)
    if lay.roll:
      parts.append((con.dist[..., ri] < 0).repeat((1,) * len(batch) + (2,)))
    parts.append(pos[..., ncrow + nang:nuni] < 0)
    parts.append(torch.ones(batch + (neq_rows,), dtype=torch.bool,
                            device=dev))
    active = torch.cat(parts, dim=-1)
    norm_row = m.const(("norm_row", nrow), lambda: torch.as_tensor(
        np.concatenate([lay.norm_row, np.zeros((nang,), bool),
                        np.ones((nlim + neq_rows,), bool)]), device=dev))
  else:
    active = torch.cat([pos[..., :nuni] < 0, torch.ones(
        batch + (neq_rows,), dtype=torch.bool, device=dev)], dim=-1)
    norm_row = torch.ones((nrow,), dtype=torch.bool, device=dev)
  bilat_np = np.concatenate([np.zeros((nuni,), bool),
                             np.ones((neq_rows,), bool)])
  bilat = m.const(("bilat", nrow), lambda: torch.as_tensor(bilat_np,
                                                           device=dev))

  imp = _impedance(pos, solimp)
  k, b = _kb(solref, solimp[..., 1])
  vel = torch.matmul(jmat, d.qvel[..., None])[..., 0]
  zero = torch.zeros((), dtype=dtype, device=dev)
  pos_term = torch.where(bilat, pos,
                         torch.where(norm_row, torch.clamp(pos, max=0.0),
                                     zero))
  aref = -imp * (k * pos_term + b * vel)

  # Delassus operator A = J M^-1 J^T, dense or matrix-free
  minv_jt = linalg.chol_solve(chol_factor, jmat.transpose(-1, -2))
  dense_amat = amat_is_dense(nrow)
  if dense_amat:
    amat = jmat @ minv_jt
    raw_diag = torch.diagonal(amat, dim1=-2, dim2=-1)

    def amat_mul(x):
      return torch.matmul(amat, x[..., None])[..., 0]
  else:
    raw_diag = torch.einsum("...rk,...kr->...r", jmat, minv_jt)

    def amat_mul(x):
      return torch.matmul(jmat, torch.matmul(minv_jt, x[..., None]))[..., 0]
  # a row no dof can move (A_rr ~ 0) is deactivated; equality rows keep
  # their compile-time diagApprox regularizer instead
  active = active & ((raw_diag > 1e-8 * torch.amax(
      raw_diag, dim=-1, keepdim=True)) | bilat)
  diag = torch.clamp(raw_diag, min=1e-10)
  reg_base = diag
  if neq_rows and len(m.eq_diagapprox) == neq_rows:
    approx = m.const(("eq_diagapprox", dtype), lambda: torch.tensor(
        m.eq_diagapprox, dtype=dtype, device=dev))
    reg_base = torch.cat([diag[..., :nuni], approx.expand(
        batch + (neq_rows,))], dim=-1)
  reg = (1.0 - imp) / imp * reg_base
  a0 = torch.matmul(jmat, qacc_smooth[..., None])[..., 0]

  ntor = len(lay.tor) if have_contacts else 0
  nroll = len(lay.roll) if have_contacts else 0

  # Jacobi preconditioning, scales tied within each tangent and rolling
  # pair so the cones stay circular
  dr = diag + reg
  dr_s = dr
  if have_contacts and len(lay.fric):
    t1i, t2i = _idx(m, "t1", lay.t1), _idx(m, "t2", lay.t2)
    mt = 0.5 * (dr[..., t1i] + dr[..., t2i])
    dr_s = dr_s.clone()
    dr_s[..., t1i] = mt
    dr_s[..., t2i] = mt
  if nroll:
    r1i = _idx(m, "r1", np.arange(ncrow + ntor, ncrow + ntor + nroll))
    r2i = _idx(m, "r2", np.arange(ncrow + ntor + nroll,
                                  ncrow + ntor + 2 * nroll))
    mr = 0.5 * (dr[..., r1i] + dr[..., r2i])
    dr_s = dr_s.clone()
    dr_s[..., r1i] = mr
    dr_s[..., r2i] = mr
  s_pre = 1.0 / torch.sqrt(torch.clamp(dr_s, min=1e-12))
  if have_contacts:
    nrm_i = _idx(m, "nrm", lay.nrm)
    s_n = s_pre[..., nrm_i]
    if len(lay.fric):
      fi = _idx(m, "fric", lay.fric)
      mu_t = con.friction[..., fi] * s_n[..., fi] / s_pre[..., t1i]
    if ntor:
      mu_tor = (con.torsion[..., ti] * s_n[..., ti] /
                s_pre[..., ncrow:ncrow + ntor])
    if nroll:
      mu_roll = con.roll[..., ri] * s_n[..., ri] / s_pre[..., r1i]
    inv = _idx(m, "inv", lay.inv)

  def disc(a, b2, cap):
    """(a, b2) scaled into the disc of radius cap: by min(1, cap / |.|),
    the norm floored at 1e-12 (the JAX package's scale, in fewer ops; the
    floor inside the root keeps its gradient finite at 0)."""
    nrm = torch.sqrt(torch.clamp(a * a + b2 * b2, min=1e-24))
    scale = torch.clamp(cap / nrm, max=1.0)
    return a * scale, b2 * scale

  def project(g):
    """Projection in preconditioned coordinates (caps with scaled mu)."""
    if have_contacts:
      gn = torch.clamp(g[..., nrm_i], min=0.0)
      if len(lay.fric):
        gt1, gt2 = disc(g[..., t1i], g[..., t2i], mu_t * gn[..., fi])
        blk = torch.cat([gn, gt1, gt2], dim=-1)[..., inv]
      else:
        blk = gn
      parts = [blk]
      if ntor:
        cap_t = mu_tor * gn[..., ti]
        parts.append(torch.maximum(torch.minimum(
            g[..., ncrow:ncrow + ntor], cap_t), -cap_t))
      if nroll:
        r1, r2 = disc(g[..., r1i], g[..., r2i], mu_roll * gn[..., ri])
        parts.extend([r1, r2])
      parts.append(torch.clamp(g[..., ncrow + nang:nuni], min=0.0))
      parts.append(g[..., nuni:])
      g = torch.cat(parts, dim=-1)
    else:
      g = torch.where(bilat, g, torch.clamp(g, min=0.0))
    return torch.where(active, g, zero)

  b_vec = a0 - aref

  # step size 1/lambda_max of the preconditioned operator
  if dense_amat:
    row_sum = (s_pre * torch.matmul(torch.abs(amat), s_pre[..., None])[..., 0]
               + s_pre * s_pre * reg)
    step = 1.0 / torch.clamp(torch.amax(torch.where(
        active, row_sum, zero), dim=-1), min=1.0)
  else:
    def opmul(v):
      v = torch.where(active, v, zero)
      sv = s_pre * v
      return torch.where(active, s_pre * (amat_mul(sv) + reg * sv), zero)

    v = active.to(dtype)
    for _ in range(_POWER_ITERS):
      w = opmul(v)
      v = w / torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1, keepdim=True),
                                     min=1e-30))
    lam = torch.sum(v * opmul(v), dim=-1)
    step = 1.0 / torch.clamp(1.25 * lam, min=1.0)
  step = step[..., None]

  def grad(g):
    f = s_pre * g
    return s_pre * (amat_mul(f) + reg * f + b_vec)

  # warm start from the previous duals, except the angular and equality
  # rows, which re-initialize from the exact per-row solution every step
  g_init = project((aref - a0) / (diag + reg) / s_pre)
  lam0 = d.efc_lambda
  if lam0 is not None and lam0.shape[-1] == nrow:
    cold = (torch.sum(torch.abs(lam0), dim=-1) == 0)[..., None]
    nw = np.zeros((nrow,), bool)
    nw[ncrow:ncrow + nang] = True
    no_warm = m.const(("no_warm", nrow), lambda: torch.as_tensor(
        nw, device=dev)) | bilat
    warm = torch.where(no_warm, g_init, lam0.to(dtype) / s_pre)
    g0 = project(torch.where(cold, g_init, warm))
  else:
    g0 = g_init

  g, y = g0, g0
  t = torch.ones(batch + (1,), dtype=dtype, device=dev)
  for _ in range(_ITERATIONS):
    g_new = project(y - step * grad(y))
    t_new = 0.5 + torch.sqrt(0.25 + t * t)  # (1 + sqrt(1 + 4 t^2)) / 2
    beta = (t - 1.0) / t_new
    dg = g_new - g
    reverse = torch.sum(dg * (y - g_new), dim=-1, keepdim=True) > 0
    y = torch.where(reverse, g_new, g_new + beta * dg)
    t = torch.where(reverse, 1.0, t_new)
    g = g_new
  f = s_pre * g

  qfrc = torch.matmul(jmat.transpose(-1, -2), f[..., None])[..., 0]
  lam_out = d.efc_lambda
  if lam_out is not None and lam_out.shape[-1] == nrow:
    lam_out = f.to(lam_out.dtype)
  if have_contacts:
    fn = f[..., nrm_i]
    if len(lay.fric):
      ft1 = torch.zeros_like(fn).index_copy(-1, fi, f[..., t1i])
      ft2 = torch.zeros_like(fn).index_copy(-1, fi, f[..., t2i])
    else:
      ft1 = ft2 = torch.zeros_like(fn)
    contact = con.replace(force=torch.stack([fn, ft1, ft2], dim=-1))
    return d.replace(qfrc_constraint=qfrc, contact=contact,
                     efc_lambda=lam_out)
  return d.replace(qfrc_constraint=qfrc, efc_lambda=lam_out)
