"""iLQG planner: exact linearization, a Riccati pass, boxQP control limits.

Counterpart of mujoco_mpc_tpu/planners/ilqg.py (reference
mjpc/planners/ilqg/: finite-difference model Jacobians, the Riccati
backward pass with regularization (backward_pass.cc:65-253), boxQP for
control limits (boxqp.h:28), a parallel line search and the time-indexed
affine feedback policy u = u_bar + alpha k + K (x - x_bar),
ilqg/policy.cc:82-140).

How the port computes each part:
  - the transition Jacobians of the whole horizon in one forward-mode
    pass (torch.autograd.forward_ad): the engine's leading batch holds
    T x (2 nv + nu) copies of the nominal states, each carrying one unit
    tangent, so one eager step of the general engine gives every column
    of every (2 nv, 2 nv + nu) Jacobian. JAX vmaps jacfwd over the
    horizon; here the engine's own batch dimension replaces the batching
    layer, which would dispatch every eager op through its batching rules;
  - the cost expansion is Gauss-Newton: residual Jacobians on kinematics,
    com_pos and com_vel (one more forward-mode pass) with the closed-form
    norm derivatives (ops/norms.py::norm_grad_hess);
  - the Riccati recursion runs backward over the horizon in the task's
    dtype, with the unregularized value function and regularized Q terms;
  - boxQP is a fixed-iteration masked projected Newton;
  - the line search's alphas are the engine's leading batch dimension: one
    batched feedback rollout.

Quaternion models are handled in the tangent space: the policy state is
x = (qpos, qvel), derivatives and feedback act on the 2 nv tangent
dx = (qpos (-) qpos_bar, qvel - qvel_bar) (estimators/base.py).

The planner never changes PyTorch's matmul precision: float32 products
stay full precision (no TF32); reduced-precision products destroy the
Riccati recursion, which is why JAX forces "highest" here. Nothing in
optimize reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from mujoco_mpc_torch.estimators import base as est_base
from mujoco_mpc_torch.estimators.base import local_diff, retract
from mujoco_mpc_torch.ops import linalg, norms
from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.physics import dynamics, kinematics
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data, Model, batch_trailing
from mujoco_mpc_torch.planners.base import (PhaseMarks, PlanInfo, log_steps,
                                             pick)
from mujoco_mpc_torch.tasks.base import Task, TaskParams

MAX_RETURN = rollout_mod.MAX_RETURN


@dataclasses.dataclass
class ILQGPolicy:
  """Time-indexed affine feedback policy."""
  xs: torch.Tensor  # (T+1, nq+nv) nominal states (qpos, qvel)
  us: torch.Tensor  # (T, nu) nominal actions
  gains: torch.Tensor  # (T, nu, 2 nv) tangent-space feedback K
  t0: torch.Tensor  # () time of step 0
  feedback_scale: torch.Tensor  # ()
  reg: torch.Tensor  # () adaptive Levenberg regularization

  def replace(self, **kw) -> "ILQGPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
  horizon: int = 100
  num_alphas: int = 8  # line-search scales
  reg: float = 1e-5  # initial Levenberg regularization on V_xx
  reg_min: float = 1e-6
  reg_max: float = 1e2
  feedback_scale: float = 1.0
  interp: str = "linear"  # feedback interpolation: "zero" | "linear"

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    m = task.model
    dt = float(m.custom("agent_timestep", float(m.opt.timestep)))
    hor = horizon_steps or int(
        round(float(m.custom("agent_horizon", 1.0)) / dt))
    return cls(horizon=hor)


def boxqp(quu: torch.Tensor, qu: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, iters: int = 8
          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """min 1/2 d^T Q d + q^T d subject to lo <= d <= hi, by a masked
  projected Newton with a fixed iteration count (reference boxqp.h:28);
  quu (..., n, n), qu, lo, hi (..., n). Returns (d, the free mask)."""
  n = qu.shape[-1]
  eye = torch.eye(n, dtype=qu.dtype, device=qu.device)
  delta = torch.clamp(torch.zeros_like(qu), lo, hi)
  free = torch.ones_like(qu)
  for _ in range(iters):
    grad = qu + (quu @ delta[..., None])[..., 0]
    clamped = (((delta <= lo + 1e-9) & (grad > 0)) |
               ((delta >= hi - 1e-9) & (grad < 0)))
    free = (~clamped).to(qu.dtype)
    mat = (quu * (free[..., :, None] * free[..., None, :]) +
           torch.diag_embed(1.0 - free) + 1e-8 * eye)
    step = linalg.solve_sym(mat, -(grad * free))  # PSD by construction
    delta = torch.clamp(delta + step * free, lo, hi)
  return delta, free


def tangent(m: Model, x: torch.Tensor, x_ref: torch.Tensor) -> torch.Tensor:
  """x (-) x_ref -> (..., 2 nv): the quaternion-aware log map on qpos."""
  nq = m.nq
  return torch.cat([local_diff(m, x[..., :nq], x_ref[..., :nq]),
                    x[..., nq:] - x_ref[..., nq:]], dim=-1)


def apply_tangent(m: Model, x_ref: torch.Tensor,
                  dx: torch.Tensor) -> torch.Tensor:
  """x_ref (+) dx -> (..., nq + nv): the retraction on qpos."""
  nq, nv = m.nq, m.nv
  return torch.cat([retract(m, x_ref[..., :nq], dx[..., :nv]),
                    x_ref[..., nq:] + dx[..., nv:]], dim=-1)


def _perturbed(m: Model, data: Data, xs: torch.Tensor, us: torch.Tensor,
               ts: torch.Tensor, dxu: torch.Tensor) -> Data:
  """data at the states xs (T, nq+nv) (+) dxu[..., :2nv], the actions us
  (T, nu) + dxu[..., 2nv:] and the times ts (T,), over the batch of dxu
  (T, 2 nv + nu)."""
  nq, nx = m.nq, 2 * m.nv
  xf = apply_tangent(m, xs[:, None, :], dxu[..., :nx])
  return rollout_mod.broadcast(data, dxu.shape[:2]).replace(
      qpos=xf[..., :nq], qvel=xf[..., nq:], ctrl=us[:, None, :] +
      dxu[..., nx:], time=ts[:, None].expand(dxu.shape[:2]))


class ILQGPlanner(PhaseMarks):
  """iLQG over the general engine."""

  mega = None  # no MegaRollout: the general engine scores every rollout

  def __init__(self, config: ILQGConfig):
    self.config = config

  # ------------------------------------------------------------------- API
  def init(self, task: Task) -> ILQGPolicy:
    m = task.model
    T = self.config.horizon
    dtype, dev = m.dtype, m.device
    # the nominal qpos is a point on the manifold (unit quaternions)
    x0 = torch.cat([m.qpos0.to(dtype),
                    torch.zeros(m.nv, dtype=dtype, device=dev)])
    return ILQGPolicy(
        xs=x0[None].repeat(T + 1, 1),
        us=task.default_ctrl()[None].repeat(T, 1),
        gains=torch.zeros((T, m.nu, 2 * m.nv), dtype=dtype, device=dev),
        t0=torch.zeros((), dtype=dtype, device=dev),
        feedback_scale=torch.tensor(self.config.feedback_scale, dtype=dtype,
                                    device=dev),
        reg=torch.tensor(self.config.reg, dtype=dtype, device=dev))

  def action(self, task: Task, policy: ILQGPolicy,
             data: Data) -> torch.Tensor:
    """u = u_bar_t + K_t (x (-) x_bar_t), the evaluated feedback of the
    two bracketing nodes interpolated linearly (reference kLinear; config
    interp "zero" holds the lower node), clamped to the control range."""
    m = task.model
    T = self.config.horizon
    x = torch.cat([data.qpos, data.qvel])
    rel = (data.time - policy.t0) / m.opt.timestep
    idx = torch.clamp(torch.floor(rel).long(), 0, T - 1)

    def feedback(i):
      dx = tangent(m, x, pick(policy.xs, i))
      return pick(policy.us, i) + policy.feedback_scale * (
          pick(policy.gains, i) @ dx)

    if self.config.interp == "zero":
      u = feedback(idx)
    else:
      frac = torch.clamp(rel - idx, 0.0, 1.0)
      u = ((1.0 - frac) * feedback(idx) +
           frac * feedback(torch.clamp(idx + 1, max=T - 1)))
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    return torch.where(m.actuator_ctrllimited, torch.clamp(u, lo, hi), u)

  def rollout_feedback(self, task: Task, tp: TaskParams, data: Data,
                       xs_ref, us_ref, gains, alpha, k_ff):
    """The feedback rollout u_t = u_bar_t + alpha k_t + K_t (x (-) x_bar_t)
    for each alpha (*b,) at once: (mean per-step cost (*b,), states
    (*b, T+1, nq+nv), actions (*b, T, nu)). The solver's warm start is
    carried from step to step."""
    m = task.model
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    d0 = rollout_mod.broadcast(data, alpha.shape)
    qpos, qvel, act, t, lam = (d0.qpos, d0.qvel, d0.act, d0.time,
                               d0.efc_lambda)
    costs, xs, us = [], [], []
    for i in range(self.config.horizon):
      dx = tangent(m, torch.cat([qpos, qvel], dim=-1), xs_ref[i])
      u = (us_ref[i] + alpha[..., None] * k_ff[i] +
           torch.matmul(dx, gains[i].transpose(0, 1)))
      u = torch.where(m.actuator_ctrllimited, torch.clamp(u, lo, hi), u)
      d = phys_step.step(m, d0.replace(qpos=qpos, qvel=qvel, act=act,
                                       time=t, ctrl=u, efc_lambda=lam))
      costs.append(rollout_mod.step_cost(task, tp, d))
      xs.append(torch.cat([d.qpos, d.qvel], dim=-1))
      us.append(u)
      qpos, qvel, act, t, lam = d.qpos, d.qvel, d.act, d.time, d.efc_lambda
    costs = torch.nan_to_num(torch.stack(costs, dim=-1), nan=MAX_RETURN,
                             posinf=MAX_RETURN, neginf=MAX_RETURN)
    x0 = torch.cat([d0.qpos, d0.qvel], dim=-1)
    return (torch.mean(costs, dim=-1), torch.stack([x0] + xs, dim=-2),
            torch.stack(us, dim=-2))

  def jacobians(self, task: Task, data: Data, xs: torch.Tensor,
                us: torch.Tensor, ts: torch.Tensor):
    """The tangent-space transition Jacobians along a nominal: A (T, 2nv,
    2nv), B (T, 2nv, nu) of dx' = f(x (+) dx, u + du) (-) x_next, from
    xs (T+1, nq+nv), us (T, nu) and the step times ts (T,): one
    forward-mode general step over T (2 nv + nu) states."""
    m = task.model
    nx = 2 * m.nv
    with est_base.dual_level():
      dxu = est_base.unit_tangents(nx + m.nu, xs, us.shape[:1])
      d = phys_step.step(m, _perturbed(m, data, xs[:-1], us, ts, dxu))
      out = tangent(m, torch.cat([d.qpos, d.qvel], dim=-1), xs[1:, None, :])
      jac = fwAD.unpack_dual(out).tangent.transpose(1, 2)
    return jac[..., :nx], jac[..., nx:]

  def cost_expansion(self, task: Task, tp: TaskParams, data: Data,
                     xs: torch.Tensor, us: torch.Tensor, ts: torch.Tensor):
    """The Gauss-Newton expansion of the per-step cost in the tangent at
    each (x, u) of xs (T, nq+nv), us (T, nu), ts (T,): gradient
    (T, 2nv+nu) and Hessian (T, 2nv+nu, 2nv+nu), from the residual's
    Jacobian (one forward-mode pass of the kinematics, com_pos, com_vel
    and the residual) and each term's norm_grad_hess."""
    m = task.model
    nxu = 2 * m.nv + m.nu
    with est_base.dual_level():
      dxu = est_base.unit_tangents(nxu, xs, us.shape[:1])
      d = kinematics.kinematics(m, _perturbed(m, data, xs, us, ts, dxu))
      d = dynamics.com_pos(m, d)
      d, _ = dynamics.com_vel(m, d)
      res = task.residual(m, batch_trailing(d),
                          tp.residual_params)  # (nres, T, nxu)
      r, jr = fwAD.unpack_dual(res)
    r = r[:, :, 0].transpose(0, 1)  # (T, nres)
    jr = jr.permute(1, 0, 2)  # (T, nres, nxu)
    grad = hess = None
    shift = 0
    for k in range(task.spec.nterm):
      dim = task.spec.dims[k]
      jb = jr[:, shift:shift + dim]
      _, g, h = norms.norm_grad_hess(
          r[:, shift:shift + dim], norms.NormType(task.spec.norm_types[k]),
          tp.norm_params[k, 0], tp.norm_params[k, 1])
      w = tp.weights[k]
      gk = w * torch.einsum("tri,tr->ti", jb, g)
      hk = w * torch.einsum("tri,trs,tsj->tij", jb, h, jb)
      grad = gk if grad is None else grad + gk
      hess = hk if hess is None else hess + hk
      shift += dim
    return grad, hess

  def backward_pass(self, task: Task, A, B, cg, ch, us, reg):
    """The Riccati recursion with boxQP (backward_pass.cc:65-253), from
    the last step to the first: (feedforward k (T, nu), gains K (T, nu,
    2nv)). Regularized Q terms drive the gains; the unregularized ones
    propagate the value function (regularization leaked into V compounds
    over the horizon)."""
    m = task.model
    nx, nu = 2 * m.nv, m.nu
    dtype, dev = us.dtype, us.device
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eps_u = 1e-6 * torch.eye(nu, dtype=dtype, device=dev)
    lim = m.actuator_ctrllimited
    dlo = torch.where(lim, m.actuator_ctrlrange[:, 0] - us,
                      torch.full_like(us, -1e9))
    dhi = torch.where(lim, m.actuator_ctrlrange[:, 1] - us,
                      torch.full_like(us, 1e9))
    cx, cu = cg[:, :nx], cg[:, nx:]
    cxx, cuu, cux = ch[:, :nx, :nx], ch[:, nx:, nx:], ch[:, nx:, :nx]
    at, bt = A.transpose(1, 2), B.transpose(1, 2)
    vx = torch.zeros(nx, dtype=dtype, device=dev)
    vxx = torch.zeros((nx, nx), dtype=dtype, device=dev)
    k_ffs, gains = [None] * us.shape[0], [None] * us.shape[0]
    for t in reversed(range(us.shape[0])):
      a, b = A[t], B[t]
      vxx_reg = vxx + reg * eye_x
      qx = cx[t] + at[t] @ vx
      qu = cu[t] + bt[t] @ vx
      qxx = cxx[t] + at[t] @ vxx @ a
      quu = cuu[t] + bt[t] @ vxx @ b + eps_u
      qux = cux[t] + bt[t] @ vxx @ a
      quu_r = cuu[t] + bt[t] @ vxx_reg @ b + eps_u
      qux_r = cux[t] + bt[t] @ vxx_reg @ a
      k_ff, free = boxqp(quu_r, qu, dlo[t], dhi[t])
      # gains on the free subspace: K = -Quu^-1 Qux, clamped rows zeroed
      quu_f = (quu_r * (free[:, None] * free[None, :]) +
               torch.diag_embed(1.0 - free))
      kmat = -linalg.solve_sym(quu_f, qux_r * free[:, None])
      kt = kmat.transpose(0, 1)
      vx = qx + kt @ quu @ k_ff + kt @ qu + qux.transpose(0, 1) @ k_ff
      vxx = qxx + kt @ quu @ kmat + kt @ qux + qux.transpose(0, 1) @ kmat
      vxx = 0.5 * (vxx + vxx.transpose(0, 1))
      k_ffs[t], gains[t] = k_ff, kmat
    return torch.stack(k_ffs), torch.stack(gains)

  def optimize(self, task: Task, policy: ILQGPolicy, data: Data,
               generator: Optional[torch.Generator] = None,
               params: Optional[TaskParams] = None
               ) -> Tuple[ILQGPolicy, PlanInfo]:
    del generator  # a deterministic planner
    cfg = self.config
    m = task.model
    tp = params if params is not None else task.params
    T = cfg.horizon
    dtype, dev = data.qpos.dtype, data.qpos.device
    # the nominal: the current feedback policy from the state, which also
    # re-anchors the time index (ilqg/planner.cc:377)
    _, xs, us = self.rollout_feedback(
        task, tp, data, policy.xs, policy.us, policy.gains,
        torch.zeros((), dtype=dtype, device=dev), torch.zeros_like(policy.us))
    self._mark("nominal rollout")
    ts = data.time + m.opt.timestep * torch.arange(T, dtype=dtype,
                                                   device=dev)
    A, B = self.jacobians(task, data, xs, us, ts)
    self._mark("jacobians")
    cg, ch = self.cost_expansion(task, tp, data, xs[:-1], us, ts)
    self._mark("cost expansion")
    k_ffs, gains = self.backward_pass(task, A, B, cg, ch, us, policy.reg)
    self._mark("riccati")
    alphas = torch.cat([torch.zeros(1, dtype=dtype, device=dev),
                        log_steps(1e-3, 1.0, cfg.num_alphas - 1, xs)])
    rets, xs_all, us_all = self.rollout_feedback(task, tp, data, xs, us,
                                                 gains, alphas, k_ffs)
    self._mark("line search")
    best = torch.argmin(rets)
    best_return = pick(rets, best)
    # the regularization ladder: down on improvement, up when even the
    # best feedforward does not beat the zero step
    improved = best_return < rets[0] - 1e-8
    new_reg = torch.clamp(torch.where(improved, policy.reg * 0.5,
                                      policy.reg * 10.0),
                          cfg.reg_min, cfg.reg_max)
    new_policy = policy.replace(xs=pick(xs_all, best), us=pick(us_all, best),
                                gains=gains, t0=data.time, reg=new_reg)
    return new_policy, PlanInfo(costs=rets, winner=best,
                                best_return=best_return)
