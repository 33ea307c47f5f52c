"""The general batched rollout: a policy through T steps of the general
engine, recording residuals and costs.

Counterpart of mujoco_mpc_tpu/ops/rollout.py (reference Trajectory::
Rollout and NoisyRollout, mjpc/trajectory.cc:92-210). JAX writes one
rollout and vmaps it over candidates; here the candidates are the leading
batch dimension of one Data (`broadcast`), so each step is one pass of the
engine over all of them, with no Python loop over candidates, and the
residual reads the batch-trailing view (types.batch_trailing). Only the
state (qpos, qvel, act, time) and the solver's warm start change from step
to step. Costs are evaluated on the step's Data (derived fields of the
state it started from, qpos and qvel after it, the step's action), and a
non-finite cost becomes MAX_RETURN (the reference's divergence guard).

This is the route for a model outside the CUDA kernel's class, for a
planner built with use_megakernel=False, and for Agent.best_trajectory.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import (Contact, Data, batch_leading,
                                            batch_trailing)
from mujoco_mpc_torch.tasks import base as task_base

MAX_RETURN = megarollout.MAX_RETURN

PolicyFn = Callable[[torch.Tensor, Data], torch.Tensor]  # (time, d) -> ctrl


class RolloutResult(NamedTuple):
  total_return: torch.Tensor  # (*b,) mean per-step cost
  costs: torch.Tensor  # (*b, T)
  qpos: torch.Tensor  # (*b, T, nq) after each step
  residuals: torch.Tensor  # (*b, T, nres)
  final: Data


def broadcast(d: Data, batch) -> Data:
  """One state's Data as a batch of `batch` copies (expanded views)."""
  batch = tuple(batch)

  def grow(obj):
    kw = {}
    for f in dataclasses.fields(obj):
      v = getattr(obj, f.name)
      if isinstance(v, Contact):
        v = grow(v)
      elif isinstance(v, torch.Tensor):
        v = v.expand(batch + v.shape)
      kw[f.name] = v
    return dataclasses.replace(obj, **kw)

  return grow(d)


def _score(task: task_base.Task, tp: task_base.TaskParams, d: Data,
           scaled: bool = True):
  """(cost (*b,), residual (nres, *b)) of a stepped Data; with `scaled`
  False, without the task's weight_mod (the derivative planners' cost, as
  in the JAX package)."""
  view = batch_trailing(d)
  res = task.residual(task.model, view, tp.residual_params)
  scale = (task.weight_mod(task.model, view, tp.residual_params)
           if scaled and task.weight_mod is not None else None)
  cost = megarollout.cost_value_t(task.spec, tp.weights, tp.norm_params,
                                  tp.risk, res, scale)
  return cost, res


def step_cost(task: task_base.Task, tp: task_base.TaskParams,
              d: Data) -> torch.Tensor:
  """The cost (*b,) of a stepped Data without the task's weight_mod: the
  per-step cost of the gradient and iLQG planners (JAX tasks.base.
  cost_value on the residual)."""
  return _score(task, tp, d, scaled=False)[0]


def run_transition(task: task_base.Task, d: Data,
                   tp: task_base.TaskParams) -> Data:
  """The task's transition on a Data with leading batch dimensions."""
  nb = d.qpos.dim() - 1
  out = task.transition(task.model, batch_trailing(d), tp.residual_params)
  return batch_leading(out, nb)


def _guard(costs: torch.Tensor) -> torch.Tensor:
  return torch.nan_to_num(costs, nan=MAX_RETURN, posinf=MAX_RETURN,
                          neginf=MAX_RETURN)


def rollout(task: task_base.Task, d0: Data, policy_fn: PolicyFn,
            horizon: int, params: Optional[task_base.TaskParams] = None,
            transition: bool = False) -> RolloutResult:
  """Roll policy_fn for `horizon` steps from d0 (one state or a batch in
  the leading dimensions); with `transition`, the task's transition runs
  before each step."""
  m = task.model
  tp = params if params is not None else task.params
  d = d0
  costs, qpos, residuals = [], [], []
  for _ in range(horizon):
    d = d.replace(ctrl=policy_fn(d.time, d))
    if transition and task.transition is not None:
      d = run_transition(task, d, tp)
    d = phys_step.step(m, d)
    cost, res = _score(task, tp, d)
    costs.append(cost)
    qpos.append(d.qpos)
    residuals.append(torch.movedim(res, 0, -1))
  costs = _guard(torch.stack(costs, dim=-1))
  return RolloutResult(torch.mean(costs, dim=-1), costs,
                       torch.stack(qpos, dim=-2),
                       torch.stack(residuals, dim=-2), d)


def rollout_return(task: task_base.Task, d0: Data, policy_fn: PolicyFn,
                   horizon: int,
                   params: Optional[task_base.TaskParams] = None
                   ) -> torch.Tensor:
  """The mean per-step cost alone (*b,) (the sampling planners' form)."""
  return rollout(task, d0, policy_fn, horizon, params).total_return


def noisy_rollout(task: task_base.Task, d0: Data, policy_fn: PolicyFn,
                  horizon: int, generator: Optional[torch.Generator] = None,
                  xfrc_std: float = 0.1, xfrc_rate: float = 0.1,
                  params: Optional[task_base.TaskParams] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Mean per-step cost under Ornstein-Uhlenbeck body wrenches (reference
  Trajectory::NoisyRollout, mjpc/trajectory.cc:147-155; the Robust
  planner's re-scoring). The standard normals come from `generator`, or
  are given as eps (T, *b, nbody, 6). The stationary std is xfrc_std,
  times the body mass on the force components."""
  m = task.model
  tp = params if params is not None else task.params
  dtype = d0.qpos.dtype
  batch = d0.qpos.shape[:-1]
  mass_scale = torch.cat([
      torch.ones((m.nbody, 3), dtype=dtype, device=d0.qpos.device),
      m.body_mass.to(dtype)[:, None].expand(m.nbody, 3)], dim=-1)
  gain = (xfrc_rate * (2 - xfrc_rate)) ** 0.5 * xfrc_std
  ou = torch.zeros(batch + (m.nbody, 6), dtype=dtype,
                   device=d0.qpos.device)
  d = d0
  costs = []
  for t in range(horizon):
    e = eps[t] if eps is not None else torch.randn(
        ou.shape, generator=generator, dtype=dtype, device=ou.device)
    ou = (1.0 - xfrc_rate) * ou + gain * mass_scale * e
    d = d.replace(ctrl=policy_fn(d.time, d), xfrc_applied=ou)
    d = phys_step.step(m, d)
    costs.append(_score(task, tp, d)[0])
  return torch.mean(_guard(torch.stack(costs, dim=-1)), dim=-1)
