"""Whole-rollout candidate scoring: one CUDA kernel launch per plan.

Counterpart of mujoco_mpc_tpu/ops/megarollout.py. The sampling planner
scores N open-loop action sequences through T physics steps and keeps the
returns (reference fan-out: mjpc/planners/sampling/planner.cc:355-393).

`MegaRollout.returns` launches the hand-written kernel in
csrc/megarollout.cu when its tensors lie on a CUDA device, and runs the
plain PyTorch version (`_rollout_body` over tilestep.step_tb) when they lie
on the CPU. There is no fallback from one to the other. Built once per
(task, horizon); TaskParams stay runtime operands.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.ops import _cuda_build
from mujoco_mpc_torch.ops import norms
from mujoco_mpc_torch.physics import tilestep
from mujoco_mpc_torch.tasks.base import (CostSpec, Task, TaskParams,
                                         risk_transform)

# reference kMaxReturnValue: divergence sentinel cost
MAX_RETURN = 1e6


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def cost_value_t(spec: CostSpec, weights, norm_params, risk, res,
                 scale=None):
  """Tile analogue of tasks.base.cost_value: res (nres, B) -> (B,);
  weights (nterm,), norm_params (nterm, 2), risk (); `scale` the optional
  (nterm, ...) multiplier of Task.weight_mod."""
  total = None
  shift = 0
  for k in range(spec.nterm):
    block = res[shift:shift + spec.dims[k]]
    val = norms.norm_value(block, spec.norm_types[k], norm_params[k, 0],
                           norm_params[k, 1], dim=0)
    term = weights[k] * val
    if scale is not None:
      term = term * scale[k]
    total = term if total is None else total + term
    shift += spec.dims[k]
  return risk_transform(total, risk)


def _rollout_body(tm, task, horizon, qpos0, qvel0, actions, scorings, t0,
                  mocap_pos, mocap_quat):
  """Mean per-step cost (N,) of actions (N, T, nu) from (qpos0, qvel0),
  with the non-finite -> MAX_RETURN divergence guard, once per scoring of
  `scorings`, (weights, norm_params, risk, residual params, userdata)
  tuples: one physics rollout serves them all, as the physics reads
  neither the task's parameters nor the userdata. The mocap poses and
  userdata (tilestep.aux_operands shapes) are rollout-constant."""
  n = actions.shape[0]
  acts = actions.permute(1, 2, 0)  # (T, nu, N)
  qpos = qpos0[:, None].expand(tm.nq, n)
  qvel = qvel0[:, None].expand(tm.nv, n)
  # APGD warm-start carry: zeros = cold first step
  lam = torch.zeros((max(tm.nrow, 1), n), dtype=qpos0.dtype,
                    device=qpos0.device)
  totals = [torch.zeros((n,), dtype=qpos0.dtype, device=qpos0.device)
            for _ in scorings]
  for i in range(horizon):
    qpos, qvel, view = tilestep.step_tb(
        tm, qpos, qvel, acts[i], efc_lambda=lam, mocap_pos=mocap_pos,
        mocap_quat=mocap_quat, userdata=scorings[0][4])
    view.time = t0 + (i + 1) * tm.timestep
    for k, (weights, norm_params, risk, res_params, userdata) in enumerate(
        scorings):
      view.userdata = userdata
      res = task.residual(task.model, view, res_params)
      scale = (task.weight_mod(task.model, view, res_params)
               if task.weight_mod is not None else None)
      totals[k] = totals[k] + cost_value_t(task.spec, weights, norm_params,
                                           risk, res, scale)
    lam = view.efc_lambda
  out = []
  for total in totals:
    total = total / horizon
    out.append(torch.where(torch.isfinite(total), total,
                           torch.full_like(total, MAX_RETURN)))
  return out


# ---------------------------------------------------------------------------
# the kernel's model struct (csrc/megarollout.cu: MRModel)
# ---------------------------------------------------------------------------

MAX_NQ, MAX_NV, MAX_BODY, MAX_JNT, MAX_NU = 32, 30, 20, 25, 24
MAX_LIM, MAX_TEN, MAX_WRAP = 24, 4, 4
MAX_TERM, MAX_RES, MAX_RES_INT, MAX_RES_FLOAT = 16, 80, 12, 32
MAX_SITE, MAX_MOCAP, MAX_USERDATA, MAX_EQ = 8, 4, 32, 4
_CON_KIND = {"plane_sphere": 0, "plane_capend": 0, "cap_cap": 1,
             "plane_boxcorner": 2, "sphere_sphere": 3, "sphere_box": 4,
             "cap_box": 5, "boxbox_corner": 6, "sphere_cap": 7}


@dataclasses.dataclass(frozen=True)
class Tier:
  """A size tier of the kernel (csrc/megarollout.cu MRSmall, MRLarge): its
  contact points, constraint rows, and whether it has the box-box pair."""
  name: str
  max_con: int
  max_row: int
  boxbox: bool


# the largest dynamic shared memory of a block on sm_90 (csrc/
# megarollout.cu MR_SMEM_MAX): a launch needs the model head and one
# candidate's working set within it
SMEM_MAX = 232448

# smallest first: MegaRollout takes the first that holds the model
TIERS = (Tier("small", 40, 130, False), Tier("large", 72, 250, True))

_I = ctypes.c_int32
# the kernel's scalar type per torch dtype
_SCALAR = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def _arr(t, *dims):
  for d in reversed(dims):
    t = t * d
  return t


def _model_struct(_F, tier: Tier):
  """ctypes mirror of MRModelT<T, tier> for the scalar type _F."""
  MAX_CON = tier.max_con  # noqa: N806 (the C maximum's name)
  BB_CON = MAX_CON if tier.boxbox else 1  # noqa: N806 (the C BBCON)
  fields = [
      ("nq", _I), ("nv", _I), ("nu", _I), ("nbody", _I), ("njnt", _I),
      ("ncon", _I), ("nfric", _I), ("ntor", _I), ("nroll", _I),
      ("neq", _I), ("neqrow", _I), ("nlim", _I),
      ("nten", _I), ("ntenlim", _I), ("nrow", _I), ("dense", _I),
      ("nterm", _I), ("nres", _I), ("res_id", _I),
      ("nmocap", _I), ("nuserdata", _I), ("nsite", _I),
      ("res_int", _arr(_I, MAX_RES_INT)),
      ("res_float", _arr(_F, MAX_RES_FLOAT)),
      ("site_body", _arr(_I, MAX_SITE)),
      ("site_pos", _arr(_F, MAX_SITE, 3)),
      ("site_quat", _arr(_F, MAX_SITE, 4)),
      ("timestep", _F), ("gravity", _arr(_F, 3)),
      ("body_parentid", _arr(_I, MAX_BODY)),
      ("body_jntadr", _arr(_I, MAX_BODY)),
      ("body_jntnum", _arr(_I, MAX_BODY)),
      ("body_mocapid", _arr(_I, MAX_BODY)),
      ("body_pos", _arr(_F, MAX_BODY, 3)),
      ("body_quat", _arr(_F, MAX_BODY, 4)),
      ("body_ipos", _arr(_F, MAX_BODY, 3)),
      ("body_iquat", _arr(_F, MAX_BODY, 4)),
      ("body_mass", _arr(_F, MAX_BODY)),
      ("body_inertia", _arr(_F, MAX_BODY, 3)),
      ("jnt_type", _arr(_I, MAX_JNT)),
      ("jnt_qposadr", _arr(_I, MAX_JNT)),
      ("jnt_dofadr", _arr(_I, MAX_JNT)),
      ("jnt_bodyid", _arr(_I, MAX_JNT)),
      ("jnt_pos", _arr(_F, MAX_JNT, 3)),
      ("jnt_axis", _arr(_F, MAX_JNT, 3)),
      ("jnt_stiffness", _arr(_F, MAX_JNT)),
      ("qpos0", _arr(_F, MAX_NQ)),
      ("qpos_spring", _arr(_F, MAX_NQ)),
      ("dof_damping", _arr(_F, MAX_NV)),
      ("dof_armature", _arr(_F, MAX_NV)),
      ("dof_frictionloss", _arr(_F, MAX_NV)),
      ("dof_body", _arr(_I, MAX_NV)),
      ("dof_body_mask", _arr(_I, MAX_NV, MAX_BODY)),
      ("dof_ancestor_mask", _arr(_I, MAX_NV, MAX_NV)),
      ("cdofdot_vel_mask", _arr(_I, MAX_NV, MAX_NV)),
      ("act_vadr", _arr(_I, MAX_NU)),
      ("act_qadr", _arr(_I, MAX_NU)),
      ("act_tendon", _arr(_I, MAX_NU)),
      ("act_gain_fixed", _arr(_I, MAX_NU)),
      ("act_bias_fixed", _arr(_I, MAX_NU)),
      ("ctrl_limited", _arr(_I, MAX_NU)),
      ("force_limited", _arr(_I, MAX_NU)),
      ("act_gear", _arr(_F, MAX_NU)),
      ("act_gainprm", _arr(_F, MAX_NU, 3)),
      ("act_biasprm", _arr(_F, MAX_NU, 3)),
      ("ctrl_lo", _arr(_F, MAX_NU)),
      ("ctrl_hi", _arr(_F, MAX_NU)),
      ("force_lo", _arr(_F, MAX_NU)),
      ("force_hi", _arr(_F, MAX_NU)),
      ("con_kind", _arr(_I, MAX_CON)),
      ("con_gbody", _arr(_I, MAX_CON, 2)),
      ("con_gpos", _arr(_F, MAX_CON, 2, 3)),
      ("con_gquat", _arr(_F, MAX_CON, 2, 4)),
      ("con_half", _arr(_F, MAX_CON, 2)),
      ("con_r", _arr(_F, MAX_CON, 2)),
      ("con_end", _arr(_F, MAX_CON)),
      ("con_margin", _arr(_F, MAX_CON)),
      ("con_mu", _arr(_F, MAX_CON)),
      ("con_tor", _arr(_I, MAX_CON)),
      ("con_mu_tor", _arr(_F, MAX_CON)),
      ("con_roll", _arr(_I, MAX_CON)),
      ("con_mu_roll", _arr(_F, MAX_CON)),
      ("con_id", _arr(_I, MAX_CON)),
      ("con_frame", _arr(_F, MAX_CON, 3, 3)),
      ("con_ppos", _arr(_F, MAX_CON, 3)),
      ("con_box", _arr(_F, MAX_CON, 3)),
      ("con_owner", _arr(_I, BB_CON)),
      ("con_size", _arr(_F, BB_CON, 2, 3)),
      ("con_guard", _arr(_F, BB_CON, 2)),
      ("con_sgn", _arr(_F, MAX_CON, MAX_NV)),
      ("con_imp", _arr(_F, MAX_CON, 5)),
      ("con_k", _arr(_F, MAX_CON)),
      ("con_b", _arr(_F, MAX_CON)),
      ("lim_qadr", _arr(_I, MAX_LIM)),
      ("lim_vadr", _arr(_I, MAX_LIM)),
      ("lim_lo", _arr(_F, MAX_LIM)),
      ("lim_hi", _arr(_F, MAX_LIM)),
      ("lim_margin", _arr(_F, MAX_LIM)),
      ("lim_k", _arr(_F, MAX_LIM)),
      ("lim_b", _arr(_F, MAX_LIM)),
      ("lim_imp", _arr(_F, 5)),
      ("ten_nwrap", _arr(_I, MAX_TEN)),
      ("ten_qadr", _arr(_I, MAX_TEN, MAX_WRAP)),
      ("ten_vadr", _arr(_I, MAX_TEN, MAX_WRAP)),
      ("ten_coef", _arr(_F, MAX_TEN, MAX_WRAP)),
      ("ten_stiffness", _arr(_F, MAX_TEN)),
      ("ten_damping", _arr(_F, MAX_TEN)),
      ("ten_lengthspring", _arr(_F, MAX_TEN, 2)),
      ("ten_lim_id", _arr(_I, MAX_TEN)),
      ("ten_lo", _arr(_F, MAX_TEN)),
      ("ten_hi", _arr(_F, MAX_TEN)),
      ("ten_margin", _arr(_F, MAX_TEN)),
      ("ten_k", _arr(_F, MAX_TEN)),
      ("ten_b", _arr(_F, MAX_TEN)),
      ("eq_kind", _arr(_I, MAX_EQ)),
      ("eq_ob1", _arr(_I, MAX_EQ)),
      ("eq_ob2", _arr(_I, MAX_EQ)),
      ("eq_data", _arr(_F, MAX_EQ, 11)),
      ("eq_k", _arr(_F, MAX_EQ)),
      ("eq_b", _arr(_F, MAX_EQ)),
      ("eq_imp", _arr(_F, MAX_EQ, 5)),
      ("eq_da", _arr(_F, MAX_EQ, 6)),
      ("term_dim", _arr(_I, MAX_TERM)),
      ("term_norm", _arr(_I, MAX_TERM)),
  ]
  return type(f"MRModel_{_F.__name__}_{tier.name}", (ctypes.Structure,),
              {"_fields_": fields})


_MODEL_STRUCT = {(tier, dt): _model_struct(f, tier)
                 for tier in TIERS for dt, f in _SCALAR.items()}


def _over_limits(tm: tilestep.TileModel, task: Task, tier: Tier):
  """What of the model exceeds the tier's maxima: (what, count, maximum)
  triples, the shared maxima first."""
  spec = task.spec
  dres = task.device_residual
  limits = [("nq", tm.nq, MAX_NQ), ("nv", tm.nv, MAX_NV),
            ("nbody", tm.nbody, MAX_BODY),
            ("njnt", tm.njnt, MAX_JNT), ("nu", tm.nu, MAX_NU),
            ("limited joints", len(tm.lim_jnt), MAX_LIM),
            ("tendons", len(tm.ten_wraps), MAX_TEN),
            ("tendon wraps", max([len(w) for w in tm.ten_wraps] or [0]),
             MAX_WRAP),
            ("equality constraints", len(tm.eq_rows), MAX_EQ),
            ("cost terms", spec.nterm, MAX_TERM),
            ("residual entries", spec.nresidual, MAX_RES),
            ("residual indices", len(dres.ints), MAX_RES_INT),
            ("residual constants", len(dres.floats), MAX_RES_FLOAT),
            ("residual sites", len(dres.sites), MAX_SITE),
            ("mocap bodies", tm.nmocap, MAX_MOCAP),
            ("userdata entries", tm.nuserdata, MAX_USERDATA),
            ("contact points", tm.ncon, tier.max_con),
            ("constraint rows", tm.nrow, tier.max_row),
            ("box-box contact points",
             sum(cp.kind == "boxbox_corner" for cp in tm.con_points),
             tier.max_con if tier.boxbox else 0)]
  return [x for x in limits if x[1] > x[2]]


def select_tier(tm: tilestep.TileModel, task: Task) -> Tier:
  """The smallest size tier that holds the model; raises
  tilestep.UnsupportedModel naming the first of the largest tier's maxima
  that the model exceeds where none does, or where the task has no CUDA
  residual."""
  if task.device_residual is None:
    raise tilestep.UnsupportedModel(
        f"task {task.name!r} has no CUDA residual in csrc/megarollout.cu")
  for tier in TIERS:
    over = _over_limits(tm, task, tier)
    if not over:
      return tier
  what, n, cap = over[0]
  raise tilestep.UnsupportedModel(
      f"{what} {n} exceed the kernel's maximum {cap} ({tier.name} tier)")


def pack_model(tm: tilestep.TileModel, task: Task,
               dtype=torch.float32) -> bytes:
  """The kernel's MRModelT for a TileModel and task, in the smallest size
  tier that holds the model, with float or double scalars for dtype
  float32 or float64 (the same float32 model values in both; the
  constants derived from them, a row's impedance, stiffness and damping
  and the box-box guard, and the residual's constants at the struct's
  precision, as the plain version reads them); raises
  tilestep.UnsupportedModel as select_tier does."""
  tier = select_tier(tm, task)
  spec = task.spec
  dres = task.device_residual
  s = _MODEL_STRUCT[tier, dtype]()

  def put(name, values, whole=False):
    """Model values at float32 in either struct; `whole` ones (the
    constants derived from them) at the struct's precision."""
    a = np.ctypeslib.as_array(getattr(s, name))
    v = np.asarray(values)
    a[:len(v)] = v if whole or a.dtype.kind != "f" else v.astype(np.float32)

  nlimj = len(tm.lim_jnt)
  fric, ones, tor, roll = tilestep.row_points(tm)
  cps, nfric = fric + ones, len(fric)
  for name, v in (("nq", tm.nq), ("nv", tm.nv), ("nu", tm.nu),
                  ("nbody", tm.nbody), ("njnt", tm.njnt),
                  ("ncon", tm.ncon), ("nfric", nfric), ("ntor", len(tor)),
                  ("nroll", len(roll)), ("neq", len(tm.eq_rows)),
                  ("neqrow", tm.neq_rows),
                  ("nlim", nlimj), ("nten", len(tm.ten_wraps)),
                  ("ntenlim", len(tm.ten_lim)), ("nrow", tm.nrow),
                  ("dense", int(tilestep.amat_is_dense(tm.nrow))),
                  ("nterm", spec.nterm), ("nres", spec.nresidual),
                  ("res_id", dres.id), ("nmocap", tm.nmocap),
                  ("nuserdata", tm.nuserdata), ("nsite", len(dres.sites)),
                  ("timestep", float(np.float32(tm.timestep)))):
    setattr(s, name, v)
  put("res_int", list(dres.ints))
  if dres.sites:
    put("site_body", [st[0] for st in dres.sites])
    put("site_pos", [st[1] for st in dres.sites])
    # a site's orientation where the residual reads its frame
    put("site_quat", [st[2] if len(st) > 2 else (1.0, 0.0, 0.0, 0.0)
                      for st in dres.sites])
  put("gravity", tm.gravity)
  for name in ("body_parentid", "body_jntadr", "body_jntnum",
               "body_mocapid", "body_pos",
               "body_quat", "body_ipos", "body_iquat", "body_mass",
               "body_inertia", "jnt_type", "jnt_qposadr", "jnt_dofadr",
               "jnt_bodyid", "jnt_pos", "jnt_axis", "jnt_stiffness", "qpos0",
               "qpos_spring", "dof_damping", "dof_armature",
               "dof_frictionloss", "dof_body", "act_vadr", "act_qadr",
               "act_gainprm", "act_biasprm", "ctrl_lo", "ctrl_hi",
               "force_lo", "force_hi"):
    put(name, np.asarray(getattr(tm, name)))
  put("act_gear", tm.act_gear)
  put("act_tendon", tm.act_tendon)
  put("act_gain_fixed", tm.act_gain_fixed.astype(np.int32))
  put("act_bias_fixed", tm.act_bias_fixed.astype(np.int32))
  put("ctrl_limited", tm.ctrl_limited.astype(np.int32))
  put("force_limited", tm.force_limited.astype(np.int32))
  mask = np.zeros((tm.nv, MAX_BODY), np.int32)
  mask[:, :tm.nbody] = tm.dof_body_mask
  put("dof_body_mask", mask)
  for name in ("dof_ancestor_mask", "cdofdot_vel_mask"):
    sq = np.zeros((tm.nv, MAX_NV), np.int32)
    sq[:, :tm.nv] = getattr(tm, name)
    put(name, sq)

  if cps:
    put("con_kind", [_CON_KIND[cp.kind] for cp in cps])
    put("con_gbody", [[tm.geom_bodyid[cp.g1], tm.geom_bodyid[cp.g2]]
                      for cp in cps])
    put("con_gpos", np.stack([tm.geom_pos[[cp.g1, cp.g2]] for cp in cps]))
    put("con_gquat", np.stack([tm.geom_quat[[cp.g1, cp.g2]] for cp in cps]))
    put("con_half", [[cp.half1, cp.half2] for cp in cps])
    put("con_r", [[cp.r1, cp.r2] for cp in cps])
    # the capsule end's offset along its axis: g1's for cap_box, g2's for
    # plane_capend
    put("con_end", [cp.sign * (cp.half1 if cp.kind == "cap_box"
                               else cp.half2) for cp in cps])
    put("con_margin", [cp.margin for cp in cps])
    put("con_mu", [cp.mu for cp in cps])
    # torsional row index of each condim-4 point, -1 for the others
    tor_ids = {id(cp): i for i, cp in enumerate(tor)}
    put("con_tor", [tor_ids.get(id(cp), -1) for cp in cps])
    put("con_mu_tor", [cp.mu_tor for cp in cps])
    # rolling row index of each condim-6 point, -1 for the others
    roll_ids = {id(cp): i for i, cp in enumerate(roll)}
    put("con_roll", [roll_ids.get(id(cp), -1) for cp in cps])
    put("con_mu_roll", [cp.mu_roll for cp in cps])
    # each point's index in tm.con_points: the order of the residual's
    # contact view
    order = {id(cp): i for i, cp in enumerate(tm.con_points)}
    put("con_id", [order[id(cp)] for cp in cps])
    # plane contacts: the constant frame and plane point
    put("con_frame", np.stack([cp.frame if cp.frame is not None
                               else np.zeros((3, 3)) for cp in cps]))
    put("con_ppos", np.stack([cp.ppos if cp.ppos is not None
                              else np.zeros(3) for cp in cps]))
    # box kinds: a corner's offset in its box's frame (plane_boxcorner,
    # boxbox_corner), the half-sizes (sphere_box, cap_box)
    put("con_box", np.stack([
        cp.size2 * cp.corner if cp.kind == "plane_boxcorner"
        else (cp.size2 if cp.owner == 2 else cp.size1) * cp.corner
        if cp.kind == "boxbox_corner"
        else cp.size2 if cp.size2 is not None else np.zeros(3)
        for cp in cps]))
    # box-box: whose corner, both boxes' half-sizes, the overhang guard
    # (fields only the box-box tier sizes by its points)
    if tier.boxbox:
      boxbox = [cp.kind == "boxbox_corner" for cp in cps]
      put("con_owner", [cp.owner for cp in cps])
      put("con_size", np.stack([np.stack([cp.size1, cp.size2]) if bb
                                else np.zeros((2, 3))
                                for cp, bb in zip(cps, boxbox)]))
      put("con_guard", [tilestep.boxbox_guard(cp) if bb else (0.0, 0.0)
                        for cp, bb in zip(cps, boxbox)], whole=True)
    sgn = np.zeros((len(cps), MAX_NV), np.float32)
    for ci, cp in enumerate(cps):
      sgn[ci, :tm.nv] = (tm.dof_body_mask[:, cp.body2].astype(np.float32)
                         - tm.dof_body_mask[:, cp.body1])
    put("con_sgn", sgn)
    params = [tilestep.pair_params(cp, dtype) for cp in cps]
    put("con_imp", [tilestep.impedance_consts(si) for _, si in params],
        whole=True)
    kbs = [tilestep.kb(sr, float(si[1])) for sr, si in params]
    put("con_k", [v[0] for v in kbs], whole=True)
    put("con_b", [v[1] for v in kbs], whole=True)
  # joint and tendon limits share the default solimp
  imp = tilestep.impedance_consts(tilestep._DEFAULT_SOLIMP)
  put("lim_imp", imp, whole=True)
  if nlimj:
    kbs = [tilestep.kb(tm.lim_solref[li], imp[1]) for li in range(nlimj)]
    put("lim_qadr", tm.lim_qadr)
    put("lim_vadr", tm.lim_vadr)
    put("lim_lo", tm.lim_lo)
    put("lim_hi", tm.lim_hi)
    put("lim_margin", tm.lim_margin)
    put("lim_k", [v[0] for v in kbs], whole=True)
    put("lim_b", [v[1] for v in kbs], whole=True)
  if tm.ten_wraps:  # every tendon: limits, springs, actuators read it
    grid = np.zeros((len(tm.ten_wraps), MAX_WRAP, 3))
    for t, ws in enumerate(tm.ten_wraps):
      grid[t, :len(ws)] = ws
    put("ten_nwrap", [len(ws) for ws in tm.ten_wraps])
    put("ten_qadr", grid[..., 0].astype(np.int32))
    put("ten_vadr", grid[..., 1].astype(np.int32))
    put("ten_coef", grid[..., 2])
    put("ten_stiffness", tm.ten_stiffness)
    put("ten_damping", tm.ten_damping)
    put("ten_lengthspring", tm.ten_lengthspring)
  if tm.ten_lim:
    put("ten_lim_id", tm.ten_lim)
    put("ten_lo", tm.ten_lim_range[:, 0])
    put("ten_hi", tm.ten_lim_range[:, 1])
    put("ten_margin", tm.ten_lim_margin)
    kbs = [tilestep.kb(sr, imp[1]) for sr in tm.ten_lim_solref]
    put("ten_k", [v[0] for v in kbs], whole=True)
    put("ten_b", [v[1] for v in kbs], whole=True)
  if tm.eq_rows:
    eqs = tm.eq_rows
    put("eq_kind", [er.kind for er in eqs])
    put("eq_ob1", [er.ob1 for er in eqs])
    put("eq_ob2", [er.ob2 for er in eqs])
    put("eq_data", np.stack([er.data for er in eqs]))
    kbs = [tilestep.kb(er.solref, float(er.solimp[1])) for er in eqs]
    put("eq_k", [v[0] for v in kbs], whole=True)
    put("eq_b", [v[1] for v in kbs], whole=True)
    put("eq_imp", [tilestep.impedance_consts(er.solimp) for er in eqs],
        whole=True)
    da = np.zeros((len(eqs), 6), np.float32)
    for e, er in enumerate(eqs):
      da[e, :er.nrows] = er.diagapprox
    put("eq_da", da)
  put("term_dim", spec.dims)
  put("term_norm", spec.norm_types)
  # the residual's constants at the struct's precision: the plain residual
  # reads them as Python floats
  np.ctypeslib.as_array(s.res_float)[:len(dres.floats)] = dres.floats
  return bytes(s)


def check_layout(layout, size, struct) -> None:
  """A ctypes mirror must match the compiled struct field by field:
  `layout(offsets, capacity)` and `size()` are a library's mr_model_layout
  and mr_model_size."""
  names = [f[0] for f in struct._fields_]
  offsets = (ctypes.c_longlong * 256)()
  count = layout(ctypes.cast(offsets, ctypes.c_void_p), 256)
  want = [getattr(struct, n).offset for n in names]
  if (count != len(names) or list(offsets[:count]) != want
      or size() != ctypes.sizeof(struct)):
    raise RuntimeError(f"{struct.__name__} layout differs between "
                       "csrc/megarollout.cu and ops/megarollout.py")


@functools.cache
def _library(tier: Tier, dtype) -> ctypes.CDLL:
  """The kernel library of one tier and precision, built on first use and
  checked against its ctypes mirror."""
  lib = _cuda_build.load(TIERS.index(tier), dtype == torch.float64)
  check_layout(lib.mr_model_layout, lib.mr_model_size,
               _MODEL_STRUCT[tier, dtype])
  return lib


# the kernel's phases, in the order of its counters (csrc/megarollout.cu
# MR_NPHASE), which only a profiling build (-DMR_PROFILE=1) carries
PHASES = ("forward kinematics", "CRB and mass matrix", "Cholesky",
          "RNE and smooth forces", "narrowphase and rows",
          "Delassus diagonal", "step size", "APGD", "integration",
          "residual and cost")


@functools.cache
def _variant(tier: Tier, dtype, contract: bool, profile: bool) -> ctypes.CDLL:
  lib = _cuda_build.load(TIERS.index(tier), dtype == torch.float64,
                         contract, profile)
  check_layout(lib.mr_model_layout, lib.mr_model_size,
               _MODEL_STRUCT[tier, dtype])
  return lib


@contextlib.contextmanager
def _swapped(dtype, contract: bool, profile: bool):
  """Every MegaRollout's kernels of `dtype` swapped for the same source
  built otherwise, on first use."""
  global _library
  library = _library

  def swapped(tier, dt):
    return (_variant(tier, dt, contract, profile) if dt == dtype
            else library(tier, dt))

  _library = swapped
  try:
    yield
  finally:
    _library = library


def float_kernels(contract: bool = True, profile: bool = False):
  """Every MegaRollout's float32 kernels swapped for the same source built
  otherwise, on first use: without multiply-add contraction (contract
  False: -fmad=false, which rounds as the plain version does, op for op)
  or with the per-phase counters that phase_cycles reads (profile)."""
  return _swapped(torch.float32, contract, profile)


def double_kernels():
  """Every MegaRollout's float64 kernels swapped for the same source built
  without multiply-add contraction (-fmad=false), on first use: what the
  double instance rounds like with the plain version's operations."""
  return _swapped(torch.float64, False, False)


def phase_cycles(tier: Tier) -> dict:
  """{phase: cycles} of the tier's float32 profiling build, summed over
  every candidate and step since the last read, which zeroes them."""
  torch.cuda.synchronize()
  buf = (ctypes.c_ulonglong * len(PHASES))()
  got = _variant(tier, torch.float32, True, True).mr_profile(
      ctypes.cast(buf, ctypes.c_void_p), 1)
  if got != len(PHASES):
    raise RuntimeError(f"mr_profile returned {got}")
  return dict(zip(PHASES, (int(c) for c in buf)))


def _check(name, t, device, shape, dtype):
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} is not contiguous")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


class MegaRollout:
  """Whole-rollout scoring for a concrete (task, horizon).

  Raises tilestep.UnsupportedModel when the model is outside the kernel's
  class; built for a CUDA device, also when the task has no CUDA residual
  or no size tier holds the model (`tier`: the smallest that does).
  The kernel runs in the dtype of its operands: float32 (the planner's) or
  float64 (to hold the kernel against the plain version in float64, where
  chaotic rollouts still compare candidate by candidate). `launches` and
  `step_launches` count the kernel launches of `returns` and `step`;
  `geometry` gives a launch's shape on the card.
  """

  def __init__(self, task: Task, horizon: int, device=devices.DEFAULT):
    self.tm = tilestep.extract(task.model)
    self.task = task
    self.horizon = int(horizon)
    self.launches = 0
    self.step_launches = 0
    self.device = devices.resolve(device)
    self.tier = None  # the kernel's size tier, on a CUDA device
    self._bufs = {}  # packed MRModelT on the card, per dtype
    self._host = {}  # and its host copy, which sizes each launch
    if self.device.type == "cuda":
      self.tier = select_tier(self.tm, task)
      self._model_buffer(self.device, torch.float32)
      _library(self.tier, torch.float32)

  def _model_buffer(self, device: torch.device, dtype) -> torch.Tensor:
    if self.device.type != "cuda" or device != self.device:
      raise ValueError(f"tensors on {device}; this MegaRollout was built "
                       f"for {self.device}")
    if dtype not in _SCALAR:
      raise ValueError(f"no kernel for {dtype}")
    if dtype not in self._bufs:
      raw = pack_model(self.tm, self.task, dtype)
      self._host[dtype] = ctypes.create_string_buffer(raw, len(raw))
      self._bufs[dtype] = torch.frombuffer(
          bytearray(raw), dtype=torch.uint8).to(self.device)
    return self._bufs[dtype]

  def _launch(self, entry: str, dtype, dev, buf, *args) -> None:
    """Calls the C entry of this tier's library in `dtype` on `dev`'s
    current stream with the packed model `buf` (and its host copy); raises
    on a CUDA error."""
    fn = getattr(_library(self.tier, dtype), entry)
    host = ctypes.addressof(self._host[dtype])
    with torch.cuda.device(dev):
      err = fn(buf.data_ptr(), host, *args,
               torch.cuda.current_stream(dev).cuda_stream)
    if err:
      raise RuntimeError(f"{entry} ({self.tier.name} tier, {dtype}) launch "
                         f"failed: CUDA error {err}")

  def _aux(self, dev, dtype, mocap_pos, mocap_quat, userdata):
    """The mocap poses and userdata as the kernel takes them, never empty:
    (nmocap, 3), (nmocap, 4), (nuserdata,), each checked; the defaults of
    tilestep.aux_operands where not given."""
    tm = self.tm
    out = []
    for name, x, default in zip(
        ("mocap_pos", "mocap_quat", "userdata"),
        (mocap_pos, mocap_quat, userdata),
        tilestep.aux_operands(tm, dtype=dtype, device=dev)):
      shape = default.shape[:-1]
      if x is None or x.numel() == 0:
        x = default.reshape(shape)
      _check(name, x, dev, shape, dtype)
      out.append(x)
    return out

  # ----------------------------------------------------------------- returns
  def returns(self, qpos0, qvel0, actions, params: TaskParams, t0,
              mocap_pos=None, mocap_quat=None, userdata=None):
    """Candidate returns (N,) for actions (N, T, nu) from qpos0 (nq,),
    qvel0 (nv,), in the dtype of `actions`; mocap_pos (nmocap, 3),
    mocap_quat (nmocap, 4) and userdata (nuserdata,) are rollout-constant
    (None: zeros, identity quaternions, zeros). CUDA tensors: the kernel;
    CPU tensors: the plain version."""
    dtype = actions.dtype
    if actions.device.type == "cpu":
      return self.returns_plain(qpos0, qvel0, actions, params, t0, dtype,
                                mocap_pos=mocap_pos, mocap_quat=mocap_quat,
                                userdata=userdata)
    if actions.device.type != "cuda":
      raise ValueError(f"no kernel for device {actions.device}")
    tm, task = self.tm, self.task
    dev = actions.device
    buf = self._model_buffer(dev, dtype)
    n = actions.shape[0]
    nterm = task.spec.nterm
    rp = params.residual_params
    if rp.numel() == 0:
      rp = torch.zeros((1,), dtype=dtype, device=dev)
    t0 = torch.as_tensor(t0, dtype=dtype, device=dev)
    _check("qpos0", qpos0, dev, (tm.nq,), dtype)
    _check("qvel0", qvel0, dev, (tm.nv,), dtype)
    _check("actions", actions, dev, (n, self.horizon, tm.nu), dtype)
    _check("weights", params.weights, dev, (nterm,), dtype)
    _check("norm_params", params.norm_params, dev, (nterm, 2), dtype)
    _check("risk", params.risk, dev, (), dtype)
    _check("residual_params", rp, dev, (max(len(task.param_names), 1),),
           dtype)
    _check("t0", t0, dev, (), dtype)
    aux = self._aux(dev, dtype, mocap_pos, mocap_quat, userdata)
    out = torch.empty((n,), dtype=dtype, device=dev)
    if n == 0:
      return out
    self._launch("mr_returns", dtype, dev, buf,
                 qpos0.data_ptr(), qvel0.data_ptr(), actions.data_ptr(),
                 params.weights.data_ptr(), params.norm_params.data_ptr(),
                 params.risk.data_ptr(), rp.data_ptr(), t0.data_ptr(),
                 *(x.data_ptr() for x in aux), out.data_ptr(), n,
                 self.horizon)
    self.launches += 1
    return out

  def returns_plain(self, qpos0, qvel0, actions, params: TaskParams, t0,
                    dtype=torch.float32, mocap_pos=None, mocap_quat=None,
                    userdata=None):
    """The same returns from the plain PyTorch version, on any device, in
    `dtype` (float32 as the planner's kernel; float64 as an arbiter of f32
    rounding); inputs are cast."""
    return self.returns_plain_variants(
        qpos0, qvel0, actions, [(params, userdata)], t0, dtype, mocap_pos,
        mocap_quat)[0]

  def returns_plain_variants(self, qpos0, qvel0, actions, variants, t0,
                             dtype=torch.float32, mocap_pos=None,
                             mocap_quat=None):
    """returns_plain under each (TaskParams, userdata) of `variants`, a
    list of returns, from one plain physics rollout (the physics reads
    neither)."""
    dev = actions.device
    scorings = []
    for params, userdata in variants:
      p = params.to(dtype=dtype)
      ud = tilestep.aux_operands(self.tm, userdata=userdata, dtype=dtype,
                                 device=dev)[2]
      scorings.append((p.weights, p.norm_params, p.risk, p.residual_params,
                       ud))
    mp, mq, _ = tilestep.aux_operands(self.tm, mocap_pos, mocap_quat,
                                      dtype=dtype, device=dev)
    return _rollout_body(
        self.tm, self.task, self.horizon, qpos0.to(dtype), qvel0.to(dtype),
        actions.to(dtype), scorings,
        torch.as_tensor(t0, dtype=dtype, device=dev), mp, mq)

  def geometry(self, n: int, dtype=torch.float32, step: bool = False):
    """The shape of a `returns` (or `step`) launch of n candidates on the
    card: warps per block (one candidate each), blocks, a candidate's
    working-set bytes, a block's shared bytes, blocks resident per SM (as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them) and SMs in
    use (computed from the launch: min(blocks, the card's SMs)). A report:
    the launch itself makes no occupancy query."""
    self._model_buffer(self.device, dtype)
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(self.device):
      err = _library(self.tier, dtype).mr_geometry(
          ctypes.addressof(self._host[dtype]), n, int(step),
          ctypes.cast(out, ctypes.c_void_p))
    if err:
      raise RuntimeError(f"mr_geometry failed: CUDA error {err}")
    return dict(zip(("warps_per_block", "blocks", "cand_bytes",
                     "smem_bytes", "blocks_per_sm", "sms_in_use"), out))

  # -------------------------------------------------------------------- step
  def step(self, qpos, qvel, ctrl, efc_lambda=None, mocap_pos=None,
           mocap_quat=None, userdata=None):
    """One step_tb on B states in tile layout: qpos (nq, B), qvel (nv, B),
    ctrl (nu, B), efc_lambda (nrow, B) or None (cold), the mocap poses and
    userdata as for `returns`, in the dtype of qpos. Returns (qpos2, qvel2,
    duals). CUDA tensors: the kernel's step; CPU: step_tb."""
    tm = self.tm
    if qpos.device.type == "cpu":
      q2, v2, view = tilestep.step_tb(tm, qpos, qvel, ctrl, efc_lambda,
                                      mocap_pos=mocap_pos,
                                      mocap_quat=mocap_quat,
                                      userdata=userdata)
      return q2, v2, view.efc_lambda
    if qpos.device.type != "cuda":
      raise ValueError(f"no kernel for device {qpos.device}")
    dev, dtype = qpos.device, qpos.dtype
    buf = self._model_buffer(dev, dtype)
    b = qpos.shape[1]
    if efc_lambda is None:
      efc_lambda = torch.zeros((tm.nrow, b), dtype=dtype, device=dev)
    ins = [x.T.contiguous() for x in (qpos, qvel, ctrl, efc_lambda)]
    for name, t, w in zip(("qpos", "qvel", "ctrl", "efc_lambda"), ins,
                          (tm.nq, tm.nv, tm.nu, tm.nrow)):
      _check(name, t, dev, (b, w), dtype)
    aux = self._aux(dev, dtype, mocap_pos, mocap_quat, userdata)
    outs = [torch.empty_like(ins[i]) for i in (0, 1, 3)]
    self._launch("mr_step", dtype, dev, buf,
                 *(t.data_ptr() for t in ins), *(x.data_ptr() for x in aux),
                 *(t.data_ptr() for t in outs), b)
    self.step_launches += 1
    return tuple(t.T for t in outs)
