"""Task system: cost specs from MJCF, residual functions, cost with risk.

Counterpart of mujoco_mpc_tpu/tasks/base.py. Cost terms are `<user>`
sensors with user="norm weight lo hi params..."; residual parameters come
from `<custom><numeric name="residual_*">`; the risk transform is
rho(l, R) = (e^{R l} - 1) / R (mjpc/task.cc:91-110).

Runtime-tunable quantities (weights, norm params, risk, residual params)
live in TaskParams, so changing them rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mujoco_mpc_torch.ops import norms
from mujoco_mpc_torch.physics.types import Model

_RISK_TOL = 1e-6
# userdata slot holding the requested task mode (reference Task::mode)
MODE_SLOT = 15


@dataclasses.dataclass
class TaskParams:
  """Runtime-mutable task quantities."""
  weights: torch.Tensor  # (nterm,)
  norm_params: torch.Tensor  # (nterm, 2)
  risk: torch.Tensor  # ()
  residual_params: torch.Tensor  # (nres_param,) residual_* custom numerics

  def replace(self, **kw) -> "TaskParams":
    return dataclasses.replace(self, **kw)

  def to(self, device=None, dtype=None) -> "TaskParams":
    return TaskParams(*(getattr(self, f.name).to(device=device, dtype=dtype)
                        for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class CostSpec:
  """Static structure of the cost: one entry per `<user>` sensor term."""
  names: Tuple[str, ...]
  norm_types: Tuple[int, ...]
  dims: Tuple[int, ...]

  @property
  def nterm(self) -> int:
    return len(self.names)

  @property
  def nresidual(self) -> int:
    return sum(self.dims)


@dataclasses.dataclass(frozen=True)
class DeviceResidual:
  """Selects a task residual written as a CUDA device function.

  `id` picks the function in csrc/megarollout.cu; `ints` are the model
  indices it reads (body, dof, body bitmask, ...), `floats` the model
  constants it reads, and `sites` the frames fixed to bodies whose world
  positions (and orientations) it reads (sites and geom centres, as (body,
  local position) or (body, local position, local quaternion)), resolved
  once from the Model."""
  id: int
  ints: Tuple[int, ...] = ()
  floats: Tuple[float, ...] = ()
  sites: Tuple[tuple, ...] = ()


def site_ref(model: Model, name: str) -> tuple:
  """A DeviceResidual site entry for the model's site `name`: (body, local
  position)."""
  sid = model.site(name)
  pos = model.site_pos.detach().cpu().numpy()[sid]
  return (model.site_bodyid[sid], tuple(float(x) for x in pos))


def home_ctrl(model: Model) -> Tuple[float, ...]:
  """The home keyframe's ctrl, a residual's constant."""
  return tuple(float(x) for x in model.keyframe("home")[2])


def probe_states(model: Model, b: int, seed: int = 0, qpos=None):
  """(qpos (nq, b), qvel (nv, b), ctrl (nu, b)) float32 numpy states about
  `qpos`, by default the home keyframe (qpos0 without one), for one-step
  checks: each hinge
  and slide moved by up to 0.3, a limited one 0.01 past its low end in
  state 1 and its high end in state 3 of every 4, moving into the limit
  at 4, with its actuator's control at that end of its range;
  each free joint's body 2 mm lower, turning about z; velocities up to
  0.5, controls over their ranges."""
  from mujoco_mpc_torch.physics.types import JointType, TrnType
  rng = np.random.RandomState(seed)
  if qpos is not None:
    q0 = np.asarray(qpos, np.float64)
  else:
    try:
      q0 = np.asarray(model.keyframe("home")[0], np.float64)
    except KeyError:
      q0 = model.qpos0.detach().cpu().numpy().astype(np.float64)
  qp = np.repeat(q0[:, None], b, 1)
  qv = rng.uniform(-0.5, 0.5, (model.nv, b))
  rng_lim = model.jnt_range.detach().cpu().numpy()
  side = np.arange(b) % 4
  for j, jt in enumerate(model.jnt_type):
    qa, va = model.jnt_qposadr[j], model.jnt_dofadr[j]
    if jt == JointType.FREE:
      qp[qa + 2] -= 0.002
      qv[va + 5] = rng.uniform(1.0, 2.0, b)
    elif jt != JointType.BALL:
      qp[qa] += rng.uniform(-0.3, 0.3, b)
      if model.jnt_limited[j]:
        lo, hi = rng_lim[j]
        qp[qa, side == 1], qv[va, side == 1] = lo - 0.01, -4.0
        qp[qa, side == 3], qv[va, side == 3] = hi + 0.01, 4.0
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  ct = rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu)).T
  for u in range(model.nu):
    j = model.actuator_trnid[u]
    if model.actuator_trntype[u] == TrnType.JOINT and model.jnt_limited[j]:
      ct[u, side == 1], ct[u, side == 3] = crange[u]
  return tuple(np.ascontiguousarray(x, np.float32) for x in (qp, qv, ct))


def const_column(model: Model, key, values, like: torch.Tensor):
  """values (n,) as a tensor in like's dtype and on its device, made once
  per model, shaped (n, 1, ...) against like's trailing batch dimensions
  (like: an (m, *b) field of a batch-trailing Data)."""
  t = model.const(("column", key, like.dtype, like.device),
                  lambda: torch.as_tensor(np.asarray(values, np.float64),
                                          dtype=like.dtype,
                                          device=like.device))
  return t.reshape(t.shape + (1,) * (like.dim() - 1))


def parse_cost_spec_mj(mj_model, model: Model, dtype, device):
  """(CostSpec, TaskParams, residual param names) from a mujoco.MjModel."""
  import mujoco

  names, norm_types, dims, weights, params = [], [], [], [], []
  for i in range(mj_model.nsensor):
    if mj_model.sensor_type[i] != mujoco.mjtSensor.mjSENS_USER:
      break
    user = mj_model.sensor_user[i]
    names.append(model.sensor_names[i])
    norm_types.append(int(user[0]))
    dims.append(int(mj_model.sensor_dim[i]))
    weights.append(float(user[1]))
    p = list(user[4:6]) + [0.0, 0.0]
    params.append((float(p[0]), float(p[1])))

  res_params, res_names = [], []
  for key, vals in model.custom_numeric:
    if key.startswith("residual_"):
      res_params.append(vals[0] if vals else 0.0)
      res_names.append(key)

  risk = model.custom("task_risk", 0.0)
  spec = CostSpec(tuple(names), tuple(norm_types), tuple(dims))

  def t(x):
    return torch.tensor(x, dtype=dtype, device=device)

  tp = TaskParams(weights=t(weights), norm_params=t(params), risk=t(risk),
                  residual_params=t(res_params))
  return spec, tp, tuple(res_names)


def cost_terms(spec: CostSpec, tp: TaskParams, residual: torch.Tensor,
               weighted: bool = True,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Per-term costs (nterm,) from a residual vector (mjpc/task.cc:71-88).
  `scale` is the optional (nterm,) state-dependent weight multiplier of
  Task.weight_mod."""
  terms = []
  shift = 0
  for k in range(spec.nterm):
    block = residual[shift:shift + spec.dims[k]]
    val = norms.norm_value(block, norms.NormType(spec.norm_types[k]),
                           tp.norm_params[k, 0], tp.norm_params[k, 1])
    if weighted:
      w = tp.weights[k] if scale is None else tp.weights[k] * scale[k]
      val = w * val
    terms.append(val)
    shift += spec.dims[k]
  return torch.stack(terms) if terms else residual.new_zeros((0,))


def risk_transform(cost: torch.Tensor, risk: torch.Tensor) -> torch.Tensor:
  """(e^{R l} - 1) / R, and l itself for |R| below tolerance."""
  small = torch.abs(risk) < _RISK_TOL
  risky = (torch.exp(risk * cost) - 1.0) / torch.where(
      small, torch.ones_like(risk), risk)
  return torch.where(small, cost, risky)


def cost_value(spec: CostSpec, tp: TaskParams, residual: torch.Tensor,
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Scalar cost with exponential risk transform (mjpc/task.cc:91-110)."""
  return risk_transform(
      torch.sum(cost_terms(spec, tp, residual, scale=scale)), tp.risk)


ResidualFn = Callable[[Model, object, torch.Tensor], torch.Tensor]
TransitionFn = Callable[[Model, object, torch.Tensor], object]


@dataclasses.dataclass
class Task:
  """A control task: model + cost spec + residual function.

  `weight_mod(model, data, residual_params)` is an optional (nterm, ...)
  state-dependent weight multiplier (the reference's Transition writing
  cost weights). `transition(model, data, residual_params)` is the task's
  FSM (reference Task::Transition), a pure function of a Data that returns
  the Data with its userdata, mocap poses or state moved on; Agent.step
  runs it before each action. Both read the component-leading,
  batch-trailing layout residuals read (one state is its own view)."""
  model: Model
  params: TaskParams
  name: str
  spec: CostSpec
  residual: ResidualFn
  param_names: Tuple[str, ...] = ()
  # task mode names (reference Task::modes); userdata[MODE_SLOT] holds the
  # requested mode index
  mode_names: Tuple[str, ...] = ("default",)
  weight_mod: Optional[ResidualFn] = None
  # the residual (and weight_mod) as CUDA device functions, for
  # MegaRollout on the card
  device_residual: Optional[DeviceResidual] = None
  transition: Optional[TransitionFn] = None

  def replace(self, **kw) -> "Task":
    return dataclasses.replace(self, **kw)

  def to(self, device) -> "Task":
    """This task with its model and parameters on `device` (the same
    Model, its engine constants built, where it is there already); the
    residual, transition and CUDA residual are kept."""
    return self.replace(model=self.model.to(device),
                        params=self.params.to(device=device))

  def cost(self, data, params: Optional[TaskParams] = None) -> torch.Tensor:
    """The scalar cost of one state's Data (its derived fields filled)."""
    tp = params if params is not None else self.params
    r = self.residual(self.model, data, tp.residual_params)
    scale = (self.weight_mod(self.model, data, tp.residual_params)
             if self.weight_mod is not None else None)
    return cost_value(self.spec, tp, r, scale)

  def residual_size(self) -> int:
    return self.spec.nresidual

  def set_mode(self, data, mode):
    """data with the task mode register userdata[MODE_SLOT] set to `mode`
    in the userdata's dtype (reference agent.proto SetMode); data itself
    is not changed."""
    ud = data.userdata.clone()
    ud[..., MODE_SLOT] = torch.as_tensor(mode, dtype=ud.dtype)
    return data.replace(userdata=ud)

  def get_mode(self, data) -> torch.Tensor:
    """The task mode register as an int32 tensor."""
    return data.userdata[..., MODE_SLOT].to(torch.int32)

  def run_transition(self, data, params: Optional[TaskParams] = None):
    """The task's transition on data (unchanged without one)."""
    if self.transition is None:
      return data
    tp = params if params is not None else self.params
    return self.transition(self.model, data, tp.residual_params)

  def default_ctrl(self) -> torch.Tensor:
    """Initial nominal control: the home keyframe's ctrl when present and
    nonzero, otherwise mid-ctrlrange."""
    m = self.model
    try:
      ctrl = torch.tensor(m.keyframe("home")[2], dtype=m.dtype,
                          device=m.device)
      if ctrl.shape[0] == m.nu and bool(torch.any(ctrl != 0)):
        return ctrl
    except KeyError:
      pass
    mid = 0.5 * (m.actuator_ctrlrange[:, 0] + m.actuator_ctrlrange[:, 1])
    return torch.where(m.actuator_ctrllimited, mid, torch.zeros_like(mid))

  def set_weight(self, name: str, value) -> "Task":
    """SetCostWeights by term name (reference agent.proto:161-170)."""
    i = self.spec.names.index(name)
    weights = self.params.weights.clone()
    weights[i] = value
    return self.replace(params=self.params.replace(weights=weights))

  def set_parameter(self, name: str, value) -> "Task":
    """SetTaskParameters by residual_* name (agent.proto:152-159)."""
    key = name if name.startswith("residual_") else f"residual_{name}"
    i = self.param_names.index(key)
    rp = self.params.residual_params.clone()
    rp[i] = value
    return self.replace(params=self.params.replace(residual_params=rp))


def _geom_radius(gtype: int, size) -> float:
  """A geom's bounding radius about its centre (0 for a plane)."""
  from mujoco_mpc_torch.physics.types import GeomType
  if gtype == GeomType.SPHERE:
    return float(size[0])
  if gtype == GeomType.CAPSULE:
    return float(size[0] + size[1])
  if gtype == GeomType.BOX:
    return float(np.linalg.norm(size))
  return 0.0


# covering_states' search: states drawn a round, rounds (more, up to 4
# times as many, until b states are kept), and the deepest contact point a
# kept state may have (m)
COVER_POOL, COVER_ROUNDS, COVER_DEPTH = 128, 4, 0.05


def covering_states(model: Model, b: int, seed: int = 0):
  """(qpos (nq, b), qvel (nv, b), ctrl (nu, b)) float32 numpy states whose
  one plain float64 step (tilestep.step_tb, cold) puts force on every
  constraint row kind of the model (tilestep.row_kinds, the box-box
  corners split by the box that holds the corner) that a seeded search
  reaches, and the kinds that carry force. Each of COVER_ROUNDS rounds
  (more, up to 4 times as many, until b states are kept) draws COVER_POOL
  states: every joint over its range widened by 10 % (limits engaged),
  free bodies at their home poses, half of them turned, lowered; in every
  other round, for each kind still without force, a free body is moved so
  that one of the kind's geom pairs overlaps (a geom of its subtree placed
  at 0.8 of the two bounding radii from the other's centre; against a
  plane, the subtree's lowest geom 1 cm into it). A state with a point
  deeper than COVER_DEPTH or a non-finite step is dropped; the kept ones
  are taken greedily, most new kinds first, then in order, b of them."""
  import torch
  from mujoco_mpc_torch.physics import tilestep
  from mujoco_mpc_torch.physics.types import GeomType, JointType
  rng = np.random.RandomState(seed)
  tm = tilestep.extract(model)
  kinds = list(tilestep.row_kinds(tm))
  fric, ones, _, _ = tilestep.row_points(tm)
  point_rows = {}
  for k, cp in enumerate(fric):
    point_rows[id(cp)] = [3 * k, 3 * k + 1, 3 * k + 2]
    if cp.kind == "boxbox_corner":
      kinds[3 * k:3 * k + 3] = [f"boxbox_corner[box {cp.owner}]"] * 3
  for k, cp in enumerate(ones):
    point_rows[id(cp)] = [3 * len(fric) + k]
  try:
    q0 = np.asarray(model.keyframe("home")[0], np.float64)
  except KeyError:
    q0 = model.qpos0.detach().cpu().numpy().astype(np.float64)
  rng_lim = model.jnt_range.detach().cpu().numpy()
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  gsize = model.geom_size.detach().cpu().numpy()
  free = [j for j, jt in enumerate(model.jnt_type) if jt == JointType.FREE]

  def draw(n):
    qp = np.repeat(q0[:, None], n, 1)
    for j, jt in enumerate(model.jnt_type):
      qa = model.jnt_qposadr[j]
      if jt in (JointType.HINGE, JointType.SLIDE):
        if model.jnt_limited[j]:
          lo, hi = rng_lim[j]
          pad = 0.1 * (hi - lo)
          qp[qa] = rng.uniform(lo - pad / 2, hi + pad / 2, n)
        else:
          qp[qa] += rng.uniform(-0.5, 0.5, n)
    for j in free:
      qa = model.jnt_qposadr[j]
      turn = rng.uniform(size=n) < 0.5
      quat = rng.randn(4, n)
      quat /= np.linalg.norm(quat, axis=0)
      qp[qa + 3:qa + 7, turn] = quat[:, turn]
      qp[qa + 2] = q0[qa + 2] * rng.uniform(0.3, 1.0, n)
    qv = rng.uniform(-0.5, 0.5, (model.nv, n))
    ct = rng.uniform(crange[:, 0], crange[:, 1], (n, model.nu)).T
    return qp, qv, ct

  def step(qp, qv, ct):
    x = [torch.tensor(a, dtype=torch.float64) for a in (qp, qv, ct)]
    _, v2, view = tilestep.step_tb(tm, *x)
    lam = view.efc_lambda.numpy()
    dist = (view.contact.dist.numpy() if tm.ncon
            else np.zeros((0, qp.shape[1])))
    got = [set(kinds[r] for r in np.nonzero(lam[:, i] != 0)[0])
           if tm.nrow else set() for i in range(qp.shape[1])]
    ok = np.isfinite(v2.numpy()).all(0) & (dist.min(0, initial=0.0)
                                           > -COVER_DEPTH)
    return got, ok, view

  def free_joint_of(bd):
    while bd > 0:
      for j in free:
        if model.jnt_bodyid[j] == bd:
          return j
      bd = model.body_parentid[bd]
    return None

  def place(qp, gx, missing):
    """Moves a free body of each state so that a pair of a missing kind
    overlaps."""
    cps = [cp for cp in tm.con_points
           if any(kinds[r] in missing for r in point_rows[id(cp)])]
    for i in range(qp.shape[1] if cps else 0):
      cp = cps[rng.randint(len(cps))]
      j1 = free_joint_of(model.geom_bodyid[cp.g1])
      j2 = free_joint_of(model.geom_bodyid[cp.g2])
      if j2 is not None and (j1 is None or rng.uniform() < 0.5):
        mv, tg, j = cp.g2, cp.g1, j2
      elif j1 is not None:
        mv, tg, j = cp.g1, cp.g2, j1
      else:
        continue
      qa = model.jnt_qposadr[j]
      if model.geom_type[tg] == GeomType.PLANE:
        sub = [g for g in range(len(model.geom_type))
               if free_joint_of(model.geom_bodyid[g]) == j]
        low = min(gx[g, 2, i] - _geom_radius(model.geom_type[g], gsize[g])
                  for g in sub)
        qp[qa + 2, i] += gx[tg, 2, i] - 0.01 - low
      else:
        u = rng.randn(3)
        u /= np.linalg.norm(u)
        r = 0.8 * (_geom_radius(model.geom_type[mv], gsize[mv])
                   + _geom_radius(model.geom_type[tg], gsize[tg]))
        qp[qa:qa + 3, i] += gx[tg, :, i] + r * u - gx[mv, :, i]

  states, got_all, ok_all = [], [], []
  covered = set()
  for rnd in range(4 * COVER_ROUNDS):
    if rnd >= COVER_ROUNDS and sum(ok_all) >= b:
      break
    qp, qv, ct = draw(COVER_POOL)
    missing = set(kinds) - covered
    if rnd % 2 and free and missing:
      place(qp, step(qp, qv, ct)[2].geom_xpos.numpy(), missing)
    got, ok, _ = step(qp, qv, ct)
    states.append((qp, qv, ct))
    got_all += got
    ok_all += list(ok)
    covered |= set().union(*[g for g, o in zip(got, ok) if o])
  cat = [np.concatenate([s[k] for s in states], 1) for k in range(3)]
  chosen, covered = [], set()
  good = [i for i, o in enumerate(ok_all) if o]
  while len(chosen) < b:
    best = max(good, key=lambda i: len(got_all[i] - covered), default=None)
    if best is None or not got_all[best] - covered:
      break
    chosen.append(best)
    covered |= got_all[best]
    good.remove(best)
  chosen += good[:b - len(chosen)]
  if len(chosen) < b:
    raise ValueError(f"only {len(chosen)} usable states of {len(ok_all)}")
  return (tuple(np.ascontiguousarray(x[:, chosen], np.float32) for x in cat),
          tuple(sorted(covered)))
