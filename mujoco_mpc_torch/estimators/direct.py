"""Direct trajectory optimizer: Gauss-Newton over configurations q_{0:T}
and, optionally, model parameters theta (smoothing and system
identification).

Counterpart of mujoco_mpc_tpu/estimators/direct.py (reference
mjpc/direct/direct.{h,cc}, math in docs/DIRECT.md:12-60; parameter
plug-ins mjpc/direct/model_parameters.h:26-52). The decision variables are
configurations; velocities and accelerations are finite differences of
them; the cost is the sensor residuals' squares, the inverse-dynamics
force residual's and a prior on theta. Each residual couples a stencil of
three configurations, so the Gauss-Newton Hessian is block-pentadiagonal
and is factored by the blocked band Cholesky (ops/band.py); with theta it
is an arrowhead [band B, C; C^T, D], solved by a Schur complement on
theta. A dense (T nv)^2 solve remains as a fallback (solver="dense").

The Jacobians are forward-mode passes (torch.autograd.forward_ad) of the
general engine's forward and inverse. The configuration columns are one
pass over (T-2) x 3 nv batch rows, row j of a stencil carrying the unit
tangent e_j of its three configurations. The engine's Model is shared by
the whole batch (its fields have no batch dimension), so the theta columns
take one more pass per parameter over the T-2 stencils, with the field's
tangent set to e_k: nθ is a handful where 3 nv rows are tens, and giving
the fields a batch dimension would change every engine stage that reads
them. For the same reason the line search over the num_steps step sizes
2^-k is one batch of num_steps x (T-2) stencils without theta and one pass
per step size with it. Each Model with parameters applied is a new object
(physics/types.py::Model.with_values) that shares the optimizer's Model's
engine constants, so that no pass copies them from the host again; only a
body_mass parameter's Models build the host copies of the masses that
subtree-momentum sensors fold in (physics/sensors.py), each its own.

An iteration reads nothing back to the host: it runs exactly
max_iterations iterations, the step is chosen by argmin on the device
(NaN costs count as inf), and the iterate is kept unless the cost fell. The
current cost is carried from the last line search (JAX computes it again;
it is the same number).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_mpc_torch.estimators import base
from mujoco_mpc_torch.ops import band
from mujoco_mpc_torch.ops.rollout import broadcast
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Model
from mujoco_mpc_torch.planners.base import PhaseMarks


@dataclasses.dataclass(frozen=True)
class ParameterSpec:
  """One model-parameter block (reference ModelParameters::Set): `apply`
  writes the theta slice into a Model (a new one); the prior adds
  0.5 w |theta - prior|^2 to the cost."""
  name: str
  dim: int
  apply: Callable[[Model, torch.Tensor], Model]
  prior: Tuple[float, ...] = ()
  prior_weight: float = 1e-3


def _indexer(idx):
  """The indices as a long tensor on a model's device, made once per
  device."""
  made = {}

  def on(device):
    if device not in made:
      made[device] = torch.tensor(idx, dtype=torch.long, device=device)
    return made[device]

  return on


def dof_damping_parameter(indices: Sequence[int], prior=None,
                          prior_weight: float = 1e-3) -> ParameterSpec:
  """theta = the damping of the given DoFs (reference
  Particle1DDampedParameters)."""
  idx = tuple(int(i) for i in indices)
  on = _indexer(idx)

  def apply(m: Model, theta: torch.Tensor) -> Model:
    return m.with_values(dof_damping=m.dof_damping.index_put(
        (on(m.device),), theta.to(m.dof_damping.dtype)))

  return ParameterSpec("dof_damping", len(idx), apply,
                       tuple(prior or [0.0] * len(idx)), prior_weight)


def body_mass_parameter(indices: Sequence[int], prior=None,
                        prior_weight: float = 1e-3) -> ParameterSpec:
  """theta = the mass of the given bodies, their inertia scaled with it
  (constant density)."""
  idx = tuple(int(i) for i in indices)
  on = _indexer(idx)

  def apply(m: Model, theta: torch.Tensor) -> Model:
    i = on(m.device)
    th = theta.to(m.body_mass.dtype)
    ratio = th / torch.clamp(m.body_mass[i], min=1e-9)
    inertia = m.body_inertia.index_put((i,), m.body_inertia[i] *
                                       ratio[:, None])
    return m.with_values(body_mass=m.body_mass.index_put((i,), th),
                         body_inertia=inertia)

  return ParameterSpec("body_mass", len(idx), apply,
                       tuple(prior or [1.0] * len(idx)), prior_weight)


def site_pos_parameter(site_ids: Sequence[int], prior=None,
                       prior_weight: float = 1e-3) -> ParameterSpec:
  """theta = the 3-D positions of the given sites (reference
  Particle1DFramePosParameters)."""
  idx = tuple(int(i) for i in site_ids)
  on = _indexer(idx)

  def apply(m: Model, theta: torch.Tensor) -> Model:
    pos = theta.reshape(len(idx), 3).to(m.site_pos.dtype)
    return m.with_values(site_pos=m.site_pos.index_put((on(m.device),),
                                                       pos))

  return ParameterSpec("site_pos", 3 * len(idx), apply,
                       tuple(prior or [0.0] * (3 * len(idx))), prior_weight)


@dataclasses.dataclass(frozen=True)
class DirectConfig:
  horizon: int  # number of configurations T (the window length)
  max_iterations: int = 10
  num_steps: int = 6  # the line search's step sizes 2^-k
  sensor_weight: float = 1.0  # scalar, or per sensor through noise_weights
  force_weight: float = 1.0  # scalar, or per dof (nv,)
  regularization: float = 1e-8
  solver: str = "band"  # "band" (blocked Cholesky) | "dense"


class DirectResult(NamedTuple):
  qpos: torch.Tensor  # (T, nq) optimized configurations
  cost: torch.Tensor  # () final cost
  cost_initial: torch.Tensor
  iterations: int
  parameters: Optional[torch.Tensor] = None  # (ntheta,) identified


class Direct(PhaseMarks):
  """Gauss-Newton smoother and system-identification optimizer; its
  `timer` hook (planners/base.py::PhaseMarks) sees the phases "initial
  cost", then in each iteration "jacobians", "band solve" and "line
  search"."""

  def __init__(self, model: Model, config: DirectConfig,
               sensor_start: int = 0, nsensordata: Optional[int] = None,
               parameters: Sequence[ParameterSpec] = (),
               noise_weights=None):
    self.model = model
    self.config = config
    self.sensor_start = sensor_start
    self.ns = (nsensordata if nsensordata is not None
               else model.nsensordata - sensor_start)
    self.parameters = tuple(parameters)
    self.ntheta = sum(p.dim for p in self.parameters)
    kw = {"dtype": model.dtype, "device": model.device}
    self.set_sensor_weights(
        torch.full((self.ns,), config.sensor_weight, **kw)
        if noise_weights is None else noise_weights)
    self._template = phys_io.make_data(model)
    self._prior = torch.tensor(
        [v for p in self.parameters for v in p.prior], **kw)
    self._prior_w = torch.tensor(
        [p.prior_weight for p in self.parameters for _ in range(p.dim)],
        **kw)

  def set_sensor_weights(self, w) -> None:
    """The per-sensor measurement weights (ns,) (reference noise_sensor,
    direct.h); config.force_weight, a scalar or per dof (nv,), weighs the
    force residual."""
    self.sensor_weights = torch.as_tensor(w, dtype=self.model.dtype,
                                          device=self.model.device)
    self._sensor_w_sqrt = torch.sqrt(self.sensor_weights)

  # --------------------------------------------------------- parameter glue
  def _apply_params(self, theta: torch.Tensor) -> Model:
    m = self.model
    off = 0
    for p in self.parameters:
      m = p.apply(m, theta[off:off + p.dim])
      off += p.dim
    return m

  def default_parameters(self) -> torch.Tensor:
    return self._prior.clone()

  def _prior_cost(self, theta: torch.Tensor) -> torch.Tensor:
    """0.5 w |theta - prior|^2 summed by block, over theta's leading
    dimensions."""
    c = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                    device=theta.device)
    off = 0
    for p in self.parameters:
      d = theta[..., off:off + p.dim] - self._prior[off:off + p.dim]
      c = c + 0.5 * p.prior_weight * torch.sum(d * d, dim=-1)
      off += p.dim
    return c

  # ------------------------------------------------------------- residuals
  def _window_residual(self, model: Model, q_prev, q_cur, q_next,
                       sensor_target, ctrl) -> torch.Tensor:
    """The residual of each stencil (q_prev, q_cur, q_next) (..., nq):
    [sensor residual; force residual] (..., ns + nv), the velocities and
    the acceleration finite differences of the configurations.

    ctrls[t] is the control applied during the step that produced
    qpos[t], so the stencil centred at q_t pairs with ctrls[t+1]; with
    that pairing and the implicit-damping term below, the force residual
    is zero on a noiseless simulated trajectory."""
    m = model
    dtype = q_cur.dtype
    h = m.opt.timestep.to(dtype)
    v_cur = base.local_diff(m, q_cur, q_prev) / h
    v_next = base.local_diff(m, q_next, q_cur) / h
    acc = (v_next - v_cur) / h
    batch = q_cur.shape[:-1]
    d = broadcast(self._template, batch).replace(
        qpos=q_cur, qvel=v_cur, qacc=acc,
        ctrl=ctrl.expand(batch + ctrl.shape[-1:]))
    df, f = phys_step.forward_inverse(m, d)
    a, b = self.sensor_start, self.sensor_start + self.ns
    r_sensor = df.sensordata[..., a:b] - sensor_target
    # the engine integrates joint damping implicitly (at v_{t+1}), so the
    # inverse consistent with the discrete step needs D (v_next - v_cur) =
    # D h acc (MuJoCo's mjENBL_INVDISCRETE analog)
    f = f + m.dof_damping.to(dtype) * h * acc
    f = f - df.qfrc_actuator  # explained by the known actuation
    force_w = self.config.force_weight  # a float (no host copy) or (nv,)
    force_w = (math.sqrt(force_w) if isinstance(force_w, (int, float))
               else torch.sqrt(force_w.to(dtype)))
    return torch.cat([self._sensor_w_sqrt.to(dtype) * r_sensor,
                      force_w * f], dim=-1)

  def _stencils(self, qs: torch.Tensor):
    return qs[..., :-2, :], qs[..., 1:-1, :], qs[..., 2:, :]

  def _total_cost(self, qs, theta, sensors, ctrls) -> torch.Tensor:
    """The cost of configurations qs (..., T, nq), one model for all."""
    model = self._apply_params(theta) if self.ntheta else self.model
    r = self._window_residual(model, *self._stencils(qs), sensors[1:-1],
                              ctrls[2:])
    costs = 0.5 * torch.sum(r * r, dim=-1)
    return torch.sum(costs, dim=-1) + self._prior_cost(theta)

  def _line_search_costs(self, qs_a, th_a, sensors, ctrls) -> torch.Tensor:
    """The cost of each of the step sizes' iterates (S, T, nq), (S, ntheta):
    one batch without parameters, a pass per step size with them."""
    if not self.ntheta:
      return self._total_cost(qs_a, th_a, sensors, ctrls)
    return torch.stack([self._total_cost(qs_a[k], th_a[k], sensors, ctrls)
                        for k in range(qs_a.shape[0])])

  # --------------------------------------------------------------- GN step
  def _stencil_blocks(self, qs, theta, sensors, ctrls):
    """The residual of each stencil (T-2, nr) and its Jacobian in the
    three configurations' tangents and theta (T-2, nr, 3 nv + ntheta)."""
    m = self.model
    nv = m.nv
    n3 = 3 * nv
    S = qs.shape[0] - 2
    model = self._apply_params(theta) if self.ntheta else m
    q3 = [q[:, None, :] for q in self._stencils(qs)]
    with base.dual_level():
      dz = base.unit_tangents(n3, qs, (S,))
      moved = [base.retract(m, q3[k], dz[..., k * nv:(k + 1) * nv])
               for k in range(3)]
      r = self._window_residual(model, *moved, sensors[1:-1, None],
                                ctrls[2:, None])
      rs = fwAD.unpack_dual(r).primal[:, 0]
      jac = base.tangent_of(r).transpose(1, 2)  # (T-2, nr, 3nv)
    if not self.ntheta:
      return rs, jac
    cols = []
    # the unit tangents, made on the device (e[k] = 1.0 copies from the host)
    eye = torch.eye(self.ntheta, dtype=theta.dtype, device=theta.device)
    for k in range(self.ntheta):
      with base.dual_level():
        r = self._window_residual(
            self._apply_params(fwAD.make_dual(theta, eye[k])),
            *self._stencils(qs), sensors[1:-1], ctrls[2:])
        cols.append(base.tangent_of(r))
    return rs, torch.cat([jac, torch.stack(cols, dim=-1)], dim=-1)

  def _gauss_newton_step(self, qs, theta, sensors, ctrls):
    """(dq (T, nv), dtheta (ntheta,)): the damped Gauss-Newton step."""
    T = self.config.horizon
    nv = self.model.nv
    nt = self.ntheta
    reg = self.config.regularization
    kw = {"dtype": qs.dtype, "device": qs.device}

    rs, jacs = self._stencil_blocks(qs, theta, sensors, ctrls)
    self._mark("jacobians")
    jq = jacs[..., :3 * nv]
    jtj = torch.einsum("tri,trj->tij", jq, jq)  # (T-2, 3nv, 3nv)
    jtr = torch.einsum("tri,tr->ti", jq, rs)  # (T-2, 3nv)

    if self.config.solver == "dense" and nt == 0:
      delta = self._dense_solve(jtj, jtr, T, nv)
      self._mark("band solve")
      return delta.reshape(T, nv), torch.zeros((0,), **kw)

    diag, off1, off2 = band.assemble_from_stencils(jtj, T)
    # Levenberg damping relative to the scale: J^T J spans ~1e9 on stiff
    # force residuals, where an absolute reg drowns in float32 roundoff
    # and the blocked Cholesky meets an indefinite matrix (a NaN factor)
    scale = torch.max(torch.abs(torch.diagonal(diag, dim1=-2, dim2=-1)))
    diag = diag + (reg + 1e-6 * scale) * torch.eye(nv, **kw)
    gq = band.scatter_grad(jtr, T)  # (T, nv)
    f_b = band.factor(diag, off1, off2)
    if nt == 0:
      dq = -band.solve(f_b, gq)
      self._mark("band solve")
      return dq, torch.zeros((0,), **kw)

    # the arrowhead system [B C; C^T D][dq; dtheta] = -[gq; gtheta]
    jth = jacs[..., 3 * nv:]  # (T-2, nr, ntheta)
    c_mat = band.scatter_grad(torch.einsum("tri,trj->tij", jq, jth), T)
    d_mat = (torch.einsum("tri,trj->ij", jth, jth) + torch.diag(self._prior_w)
             + reg * torch.eye(nt, **kw))
    gth = (torch.einsum("tri,tr->i", jth, rs) +
           self._prior_w * (theta - self._prior))
    x = band.solve(f_b, c_mat)  # B^-1 C, (T, nv, ntheta)
    y = band.solve(f_b, gq)  # B^-1 gq, (T, nv)
    s = d_mat - torch.einsum("tik,til->kl", c_mat, x)
    dth = torch.linalg.solve_ex(
        s, -(gth - torch.einsum("tik,ti->k", c_mat, y)),
        check_errors=False).result
    dq = -band.solve(f_b, gq + torch.einsum("tik,k->ti", c_mat, dth))
    self._mark("band solve")
    return dq, dth

  def _dense_solve(self, jtj, jtr, T: int, nv: int) -> torch.Tensor:
    """The dense fallback: the (T nv)^2 Hessian assembled stencil by
    stencil, damped as the band path, solved whole."""
    ntot = T * nv
    hess = jtj.new_zeros((ntot, ntot))
    grad = jtr.new_zeros((ntot,))
    for t in range(T - 2):
      sl = slice(t * nv, (t + 3) * nv)
      hess[sl, sl] += jtj[t]
      grad[sl] += jtr[t]
    scale = torch.max(torch.abs(torch.diagonal(hess)))
    hess = hess + (self.config.regularization + 1e-6 * scale) * torch.eye(
        ntot, dtype=hess.dtype, device=hess.device)
    return -torch.linalg.solve_ex(hess, grad, check_errors=False).result

  # ------------------------------------------------------------------- API
  def optimize(self, qpos_init: torch.Tensor, sensors: torch.Tensor,
               ctrls: Optional[torch.Tensor] = None,
               params_init: Optional[torch.Tensor] = None) -> DirectResult:
    """Smooth the window, and identify the parameters where configured:
    qpos_init (T, nq), sensors (T, ns), ctrls (T, nu) -> the optimum."""
    m = self.model
    cfg = self.config
    T = cfg.horizon
    kw = {"dtype": qpos_init.dtype, "device": qpos_init.device}
    if ctrls is None:
      ctrls = torch.zeros((T, m.nu), **kw)
    theta = (params_init if params_init is not None
             else self.default_parameters().to(qpos_init.dtype))
    cost0 = self._total_cost(qpos_init, theta, sensors, ctrls)
    self._mark("initial cost")
    steps = 2.0 ** -torch.arange(cfg.num_steps, **kw)
    qs, cur = qpos_init, cost0
    for _ in range(cfg.max_iterations):
      dq, dth = self._gauss_newton_step(qs, theta, sensors, ctrls)
      qs_a = base.retract(m, qs[None], steps[:, None, None] * dq[None])
      th_a = (theta[None] + steps[:, None] * dth[None] if self.ntheta
              else theta[None].expand(cfg.num_steps, 0))
      costs = self._line_search_costs(qs_a, th_a, sensors, ctrls)
      # NaN costs (diverged trial steps) neither win nor leak into the
      # reported cost, which is the kept iterate's
      best = torch.argmin(torch.where(torch.isnan(costs),
                                      torch.full_like(costs, float("inf")),
                                      costs)).reshape(1)
      cost_best = costs.index_select(0, best)[0]
      improved = cost_best < cur
      qs = torch.where(improved, qs_a.index_select(0, best)[0], qs)
      theta = torch.where(improved, th_a.index_select(0, best)[0], theta)
      cur = torch.where(improved, cost_best, cur)
      self._mark("line search")
    return DirectResult(qpos=qs, cost=cur, cost_initial=cost0,
                        iterations=cfg.max_iterations,
                        parameters=theta if self.ntheta else None)
